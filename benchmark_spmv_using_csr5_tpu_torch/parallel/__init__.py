"""Row-block distribution over ``torch.distributed``: CSR5
(:mod:`.distributed`) and DIA (:mod:`.distributed_dia`) with all-gather
and halo exchanges of x, the weak-scaling sweep and its projection
(:mod:`.scaling`), and the process groups they run in (:mod:`.launch`).
The counterpart of ``benchmark_spmv_using_csr5_tpu/parallel/``.
"""
