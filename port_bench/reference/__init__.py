"""The plain reference the benchmark holds the port against.

Plain PyTorch in float32 with TF32 off: ``model`` is the forward pass of
the configurations, layer by layer as their patterns name the sublayers
in ``layers/`` (Mamba-2, grouped-query attention, top-k MoE with per-row
capacity, SwiGLU FFN), ``train`` the loss and AdamW steps.  It imports nothing of the port and takes nothing the port made:
the weights and tokens come from the benchmark's own generators.
"""
