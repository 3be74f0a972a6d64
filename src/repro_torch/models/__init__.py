"""Model zoo: the layer library and the assembled language models (the
dense family so far)."""
