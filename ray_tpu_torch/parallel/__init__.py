"""Several devices: image bands over ``torch.distributed`` ranks."""
