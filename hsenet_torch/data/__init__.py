"""Host-side data of the port: tokenization, batching, synthetic sets."""
