"""cm3d_tpu_torch — the PyTorch/CUDA port of cm3d_tpu for NVIDIA Hopper.

Two stages of the pipeline run here on plain PyTorch tensor code plus
hand-written CUDA C++ kernels for sm_90a (`kernels/`, sources in `csrc/`):
the 2D mask stage (camera images -> Detic -> SAM -> RLE artifacts), whose
Swin blocks run a fused window-attention kernel, and the nuScenes 2D->3D
lift (mask artifacts + LiDAR sweeps -> submission JSON), with
order-preserving row compaction and masked medoid distance sums. Module
paths mirror `cm3d_tpu/`; this package imports neither JAX nor anything of
`cm3d_tpu`.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a CPU
tensor each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
