"""Host-side scene construction (numpy) and finalize into a
:class:`ray_tpu_torch.scene.scene.SceneFlat` of torch tensors."""
