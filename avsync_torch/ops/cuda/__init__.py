"""Hand-written Hopper (sm_90a) kernels, each beside its plain PyTorch twin.

  * `convpool` — fused conv1 + ReLU + MaxPool (csrc/conv1_pool.cu)
  * `gru`      — whole-sequence GRU recurrence (csrc/gru_fwd.cu)

Kernels are built with nvcc at first use (`build`), never at import.
"""
