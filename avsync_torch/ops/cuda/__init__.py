"""Hand-written Hopper (sm_90a) kernels, each beside its plain PyTorch twin.

  * `convpool` — fused conv1 + ReLU + MaxPool (csrc/conv1_pool.cu) and its
                 weight gradient (csrc/conv1_pool_bwd.cu)
  * `gru`      — whole-sequence GRU recurrence (csrc/gru_fwd.cu) and its
                 backward (csrc/gru_bwd.cu)
  * `mfcc`     — fused mel -> dB -> DCT -> MFCC statistics (csrc/mel_stats.cu)
  * `quantconv` — int8 conv + dequant + ReLU + MaxPool block of int8 serving
                 (csrc/int8_conv_pool.cu)

Kernels are built with nvcc at first use (`build`), never at import.
"""
