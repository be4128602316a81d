"""The parameters carried across: the port's SiftConfig built from the JAX
config's fields, and everything derived from it (octave sigmas, octave
count, Gaussian taps) bit-equal to the JAX package's."""

import dataclasses

import numpy as np
import pytest

from sift_features_tpu.config import SiftConfig as JConfig
from sift_features_tpu.ops import gaussian as jg
from sift_features_tpu_torch.config import (SiftConfig, check_supported,
                                            config_from_reference)
from sift_features_tpu_torch.ops import gaussian as tg


@pytest.mark.parametrize("fields", [{}, {"scales_per_octave": 4}])
def test_config_and_taps_bit_equal(fields):
    jcfg = JConfig(**fields)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg == SiftConfig(**fields)
    js, ts = jcfg.octave_sigmas(), cfg.octave_sigmas()
    assert np.array_equal(np.float64(js).view(np.int64),
                          np.float64(ts).view(np.int64))
    for hw in [(16, 16), (96, 128), (2160, 3840), (481, 641), (7, 3)]:
        assert cfg.n_octaves(*hw) == jcfg.n_octaves(*hw)
    for s in ts[1:] + [cfg.seed_sigma]:
        assert tg.cv_ksize(s) == jg.cv_ksize(s)
        np.testing.assert_array_equal(
            tg.gaussian_kernel(s, tg.cv_ksize(s)).view(np.int32),
            jg.gaussian_kernel(s, jg.cv_ksize(s)).view(np.int32))


def test_config_unknown_field_and_unported_modes_raise():
    """Unknown fields and unknown mode names raise ValueError; every mode
    of the JAX config passes, and the storage flags follow the JAX extractor
    (models/extractor.py:498-500: gather16 only over f32 storage)."""
    with pytest.raises(ValueError):
        config_from_reference({"not_a_field": 1})
    for bad in ({"storage_dtype": "float16"}, {"storage_dtype": "bf16"},
                {"gather_dtype": "split"}, {"refine_mode": "walks"},
                {"window_kernel": "packd"}):
        with pytest.raises(ValueError):
            check_supported(SiftConfig(**bad))
    for ported in ({"storage_dtype": "bfloat16"}, {"storage_dtype": "split"},
                   {"gather_dtype": "bfloat16"}, {"refine_mode": "step"},
                   {"refine_mode": "tile"},
                   {"refine_mode": "region", "region_steps": 1},
                   {"window_kernel": "perkey"}):
        check_supported(SiftConfig(**ported))
        jcfg = JConfig(**ported)
        assert config_from_reference(dataclasses.asdict(jcfg)) == SiftConfig(**ported)
    for fields, flags in (({}, (False, False)),
                          ({"gather_dtype": "bfloat16"}, (True, False)),
                          ({"storage_dtype": "split"}, (False, True)),
                          ({"storage_dtype": "split", "gather_dtype": "bfloat16"},
                           (False, True)),
                          ({"storage_dtype": "bfloat16",
                            "gather_dtype": "bfloat16"}, (False, False))):
        cfg = SiftConfig(**fields)
        assert (cfg.gather16, cfg.split) == flags, fields
