"""Host utilities (tokenizer)."""
