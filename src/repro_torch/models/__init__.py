"""The LM stack on PyTorch: configs, parameter modules, attention (K6),
Mamba-2 (K7), the KV cache on the polymorphic record layout, layer blocks
and the LM's training loss, prefill and decode."""
