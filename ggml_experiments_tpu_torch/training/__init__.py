"""Training-side modules; so far the character-LM data pipeline."""
