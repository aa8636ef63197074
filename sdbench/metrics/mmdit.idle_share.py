"""mmdit.idle_share: ``device.idle_share``'s reading
(``sdbench/metrics/device.idle_share.py``) in the SD3 cell: the share of
the traced slice of whole requests in which no kernel, copy or set ran on
the card."""

from sdbench import run

LAYER = "device"
MOVES = "images_per_s"
UNIT = "%"

read = run.reader("device.idle_share").read
