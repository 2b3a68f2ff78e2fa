"""Shared parts of the harness: specs, peaks, counts, generators, trace."""
