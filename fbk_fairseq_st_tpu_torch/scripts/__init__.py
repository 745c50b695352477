"""Scripts of the port, each run with ``python -m``: the flash sweep (on the
card), and the FBK papers' data preparation and evaluation (on the host)."""
