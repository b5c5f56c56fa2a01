"""Probes of the card's streaming rate, counterparts of the repository's
TPU probes: ``hbm_stream`` (``scripts/probe_hbm_stream.py``) and
``dma_overlap`` (``scripts/probe_dma_overlap.py``). Each runs as
``python -m a_nice_rag_tpu_torch.probes.<name>`` on a CUDA GPU and
prints one JSON object per line."""
