"""The port's data helpers: the numpy radar simulator and the 4-bit wire
format (copies of the JAX package's ``data/synthetic.py`` and
``data/packing.py``), and in their own modules the MulRan reader
(``mulran``), the sequence writer (``make_sequence``) and the PNG codec
they share (``png``)."""

from navtech_radar_slam_torch.data.packing import pack4, unpack4_reference  # noqa: F401
from navtech_radar_slam_torch.data.synthetic import RadarSimulator, SimConfig  # noqa: F401
