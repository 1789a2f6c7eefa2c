"""Model definition: layers, GQA attention, the MoE FFN and the
transformer ``nn.Module``."""
