"""Rendering and gradient steps over several processes (``torch.distributed``)."""
