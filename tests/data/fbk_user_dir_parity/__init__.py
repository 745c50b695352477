"""An empty --user-dir package for tests/test_torch_options_parity.py."""
