"""Models: the CLIP text encoder, the UNet and its ControlNet, the MMDiT, the
VAE, the safety checker and the multilingual projection."""
