"""Weight file formats (the reference's gru.bin)."""
