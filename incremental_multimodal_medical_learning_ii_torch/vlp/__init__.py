"""Joint image-text inference: similarity scores and phrase grounding."""
