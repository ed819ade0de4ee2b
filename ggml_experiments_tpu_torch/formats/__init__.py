"""Weight file formats: the reference's gru.bin and the native .gxt container."""
