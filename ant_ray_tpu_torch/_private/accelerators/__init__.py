"""Accelerator detection of the port: NVIDIA cards (``gpu``)."""
