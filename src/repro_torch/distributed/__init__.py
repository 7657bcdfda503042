"""Context-parallel verification (counterpart of ``repro/distributed``'s
``cp_verify`` and ``cp_retrieval``) on ``torch.distributed``: each rank
holds a contiguous sequence shard of the KV cache, runs the verify (K1)
and retrieval-score (K3) kernels over it, and one all-reduce merge of the
softmax partials replaces any gather of K/V.  The caller initialises the
process group and passes it; nothing here picks a backend."""
from repro_torch.distributed.cp_retrieval import (cp_partial_verify_attention,
                                                  cp_partial_verify_single,
                                                  local_partial_partials,
                                                  local_selection)
from repro_torch.distributed.cp_verify import (cp_full_verify_attention,
                                               cp_full_verify_single,
                                               gathered_blocks_bytes,
                                               local_full_partials,
                                               merged_partials_bytes,
                                               psum_softmax_merge,
                                               verify_traffic_report)

__all__ = ["cp_full_verify_attention", "cp_partial_verify_attention",
           "psum_softmax_merge", "merged_partials_bytes",
           "gathered_blocks_bytes", "verify_traffic_report",
           "cp_full_verify_single", "cp_partial_verify_single",
           "local_full_partials", "local_partial_partials",
           "local_selection"]
