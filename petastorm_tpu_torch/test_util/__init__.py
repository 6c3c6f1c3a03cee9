"""Test utilities of the port (``petastorm_tpu/test_util/``, trimmed)."""
