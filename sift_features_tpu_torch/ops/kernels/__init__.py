"""Hand-written CUDA kernels of the port, one module per kernel family.

Each module holds the kernel's wrapper, its plain PyTorch version and a note
naming the TPU kernel it replaces. IDs are those of PERF.md's kernel table;
a primed ID (K2′, K5′, K6′) is the single-frame or count-prefix variant of
the same TPU `_kernel`, served by the same CUDA kernel. A wrapper runs the plain version for a
CPU tensor and launches the kernel for a CUDA tensor (or raises); the
launch counts live in `build.LAUNCHES`. A name with a suffix is a storage
form of the kernel (SiftConfig.storage_dtype / gather_dtype): `:bf16`
reads bf16 planes, `K1:split` / `K9:split` store bf16 Gaussian levels and
an f32 DoG, `K1:g16` / `K9:g16` add a bf16 copy of the Gaussian levels.
"""

# name -> (CUDA source, the TPU kernel it replaces; None where it replaces
# none: M1, the matcher, which the JAX package leaves to XLA)
KERNELS = {
    "M1": ("sift_features_tpu_torch/csrc/matcher.cu", None),
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
    "K2′": ("sift_features_tpu_torch/csrc/extrema.cu",
            "sift_features_tpu/ops/pallas/extrema_kernel.py:133"),
    "K5′": ("sift_features_tpu_torch/csrc/orientation.cu",
            "sift_features_tpu/ops/pallas/orientation_packed.py:345"),
    "K6′": ("sift_features_tpu_torch/csrc/descriptor.cu",
            "sift_features_tpu/ops/pallas/descriptor_packed.py:358"),
    "K9": ("sift_features_tpu_torch/csrc/pyramid.cu",
           "sift_features_tpu/ops/pallas/pyramid_kernel.py:128"),
    "K7": ("sift_features_tpu_torch/csrc/descriptor.cu",
           "sift_features_tpu/ops/pallas/descriptor_kernel.py:248"),
    "K8": ("sift_features_tpu_torch/csrc/orientation.cu",
           "sift_features_tpu/ops/pallas/orientation_kernel.py:205"),
    "K10": ("sift_features_tpu_torch/csrc/refine.cu",
            "sift_features_tpu/ops/pallas/refine_region_kernel.py:204"),
    "K11": ("sift_features_tpu_torch/csrc/refine.cu",
            "sift_features_tpu/ops/pallas/refine_tile_kernel.py:291"),
}
_PYR = "sift_features_tpu/ops/pallas/pyramid_kernel.py:"
KERNELS.update({
    "K1:bf16": (KERNELS["K1"][0], _PYR + "352"),
    "K1:split": (KERNELS["K1"][0], _PYR + "352"),
    "K1:g16": (KERNELS["K1"][0], _PYR + "352"),
    "K9:bf16": (KERNELS["K9"][0], _PYR + "128"),
    "K9:split": (KERNELS["K9"][0], _PYR + "128"),
    "K9:g16": (KERNELS["K9"][0], _PYR + "128"),
    **{f"{k}:bf16": KERNELS[k] for k in ("K2", "K4", "K5", "K6", "K6′", "K7",
                                         "K8")}})
