"""Models of the PyTorch port: GPT-2 (`gpt2`), its paged KV cache (`kv_cache`)
and batch generation (`generation`)."""
