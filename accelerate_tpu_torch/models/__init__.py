"""Models of the PyTorch port: GPT-2 (`gpt2`), its paged KV cache (`kv_cache`),
batch generation (`generation`) and the Llama family for training
(`llama`)."""
