"""The gat2 FragNet model: layers, encoder, heads and the finetune model."""
