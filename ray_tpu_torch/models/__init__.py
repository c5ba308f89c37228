"""The denoisers: joint non-local means (:mod:`.nlm`) and the UNet
(:mod:`.unet`)."""
