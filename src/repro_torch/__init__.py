"""PyTorch port of the DistGER embedding system (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout module by module (``repro_torch.graph.csr`` <-> ``repro.graph.csr``)
and imports nothing of it. Entry points take ``device=`` and default to
``"cuda"``; the one hand-written kernel on the main path, the SGNS
lifetime update, lives in ``repro_torch.kernels.sgns``.
"""
