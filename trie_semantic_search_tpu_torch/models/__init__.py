"""Tokenizer, MiniLM encoder and the serving embedder."""
