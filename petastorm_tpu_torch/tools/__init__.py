"""Operator CLIs of the port: dataset inspection, copy and pipeline diagnosis.

Counterpart of ``petastorm_tpu/tools/``; the console scripts are
``petastorm-tpu-torch-metadata``, ``petastorm-tpu-torch-copy-dataset`` and
``petastorm-tpu-torch-diagnose``.
"""
