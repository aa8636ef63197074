"""mmdit.mfu: ``mfu``'s reading (``sdbench/metrics/mfu.py``) in the SD3
cell: the operations of every model call in the window (the text rows of
CLIP-L, bigG and T5, the MMDiT at each step's CFG batch, the VAE decoder's
images, counted by the SD3 family's ``model_flops``) over the window's wall
seconds, less the profiler's, times the card's bf16 peak (989 TFLOP/s)."""

from sdbench import run

LAYER = "the whole generation"
MOVES = "images_per_s"
UNIT = "%"

read = run.reader("mfu").read
