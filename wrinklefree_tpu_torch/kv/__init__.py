"""Paged KV cache (dual layout) and the paged forward."""
