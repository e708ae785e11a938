"""Serving layer of the port: paged KV cache, continuous batcher and
engine (``python -m tpu_p2p_torch serve``)."""

from tpu_p2p_torch.serve.batcher import (  # noqa: F401
    Batcher,
    Request,
    percentile,
    simulate_schedule,
)
from tpu_p2p_torch.serve.paged_cache import (  # noqa: F401
    OutOfPages,
    PagePool,
    PrefixIndex,
    TRASH_PAGE,
    init_paged_pool,
    kv_page_bytes,
    make_paged_lm_step,
)
