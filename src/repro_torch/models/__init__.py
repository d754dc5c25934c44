"""Model code: shared blocks, attention, MLP, layer blocks, full model."""
