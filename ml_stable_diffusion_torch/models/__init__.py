"""Models: the CLIP and T5 text encoders, the UNet and its ControlNet, the
MMDiT and its SD3 ControlNet, the VAE, the safety checker, the CLIP vision
encoder and IP-Adapter projections, and the multilingual projection."""
