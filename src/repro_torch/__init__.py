"""PyTorch port of the DistGER embedding system (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout module by module (``repro_torch.graph.csr`` <-> ``repro.graph.csr``)
and imports nothing of it. Entry points take ``device=`` and default to
``"cuda"``. The hand-written kernels live under ``repro_torch.kernels``:
the SGNS lifetime update (``sgns``, the embedding path), flash attention
(``flash_attention``) and the chunked SSD scan (``ssm_scan``), the last
two on the LM serving path.
"""
