"""Hand-written CUDA kernels of the port, one module per kernel family.

Each module holds the kernel's wrapper, its plain PyTorch version and a note
naming the TPU kernel it replaces. A wrapper runs the plain version for a
CPU tensor and launches the kernel for a CUDA tensor (or raises); the
launch counts live in `build.LAUNCHES`.
"""

# name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "K1": ("sift_features_tpu_torch/csrc/pyramid.cu",
           "sift_features_tpu/ops/pallas/pyramid_kernel.py:352"),
    "K2": ("sift_features_tpu_torch/csrc/extrema.cu",
           "sift_features_tpu/ops/pallas/extrema_kernel.py:181"),
    "K3": ("sift_features_tpu_torch/csrc/refine.cu",
           "sift_features_tpu/ops/pallas/refine_walk_kernel.py:335"),
    "K4": ("sift_features_tpu_torch/csrc/refine.cu",
           "sift_features_tpu/ops/pallas/refine_kernel.py:206"),
    "K5": ("sift_features_tpu_torch/csrc/orientation.cu",
           "sift_features_tpu/ops/pallas/orientation_packed.py:421"),
    "K6": ("sift_features_tpu_torch/csrc/descriptor.cu",
           "sift_features_tpu/ops/pallas/descriptor_packed.py:415"),
}
