"""Search engine, fused hybrid search, snippets and host caches."""
