"""Models of the PyTorch port: GPT-2 (`gpt2`), its paged KV cache (`kv_cache`),
batch generation (`generation`), the Llama family (`llama`) and Mixtral
(`mixtral`), BERT (`bert`), ResNet (`resnet`), the T5 encoder-decoder (`t5`)
and the Vision Transformer (`vit`). Nothing is imported eagerly: import the
family's module."""
