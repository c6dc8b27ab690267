"""Multi-card pricing (port of ``mc_tpu/parallel/``).

So far the model table (``models_sharded``: ``ShardedModel``,
``SHARDED_MODELS``), which ``checkpoint.chunked_price(model=...)`` reads.
The sharded entry points (``price_sharded``, ``price_model_sharded`` and
the rest, a ``torch.distributed`` all-reduce over the cards) wait for
ROADMAP item 20.
"""

from mc_tpu_torch.parallel.models_sharded import SHARDED_MODELS, ShardedModel

__all__ = ["SHARDED_MODELS", "ShardedModel"]
