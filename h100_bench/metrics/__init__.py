"""One reader per per-layer metric, loaded by file name (names hold dots)."""
