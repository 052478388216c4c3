"""igcn_cf — an inductive embedding/retrieval engine in JAX, run on an NVIDIA H100.

Brand-new framework with the capabilities of the INMO reference implementation
(WuYunfan/igcn_cf, SIGIR'22): the full collaborative-filtering model zoo (MF,
LightGCN, IGCN/INMO, IMF, NGCF, IMCGAE, IDCF-LGCN, MultiVAE, NeuMF, ItemKNN,
Popularity), BPR/BCE/VAE training, masked full-catalog top-k retrieval with
Precision/Recall/NDCG@k, and the transductive / dropit / dropui inductive
evaluation protocols — re-designed for an accelerator:

  * functional models over explicit parameter pytrees, jitted train steps
  * graph propagation as static-shape sparse matmuls (XLA segment-sum) and a
    precomputed propagation cache read by a Pallas (Triton) gather+matmul,
    instead of DGL gspmm (reference model.py:102)
  * device-side negative sampling instead of 6 DataLoader worker processes
    (reference trainer.py:226-227, dataset.py:119-131)
  * row-sharded embedding tables over a jax.sharding.Mesh with XLA collectives
    for multi-device scale (new capability — the reference is single-GPU,
    SURVEY.md §2.2)
"""

__version__ = "0.1.0"

from igcn_cf.core.registry import DATASETS, MODELS, TRAINERS  # noqa: F401
