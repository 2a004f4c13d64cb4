"""The LLM substrate in PyTorch: layers, MoE, Mamba and xLSTM blocks, the
ten registered architectures' models, and their train, prefill and decode
steps. Plain PyTorch throughout: the reference reaches no TPU kernel
here."""
