"""repro_torch.tune — the port's kernel autotuner (port of ``repro.tune``):
per-kernel search spaces over the CUDA kernels' launch-shape knobs
(``space``), a measured runner with an analytic H100 cost model
(``runner``), and a persistent config cache keyed (kernel, shape, dtype,
backend) with an in-process memo (``cache``), consulted by
``repro_torch.kernels.ops`` whenever a ``"cuda"`` call has no explicit
``config=``. ``python -m repro_torch.tune`` pre-tunes the paper's Table-2
shapes and whole CNN plans into a cache file; ``REPRO_TORCH_TUNE_CACHE``
names the file the dispatch layer loads."""
from .cache import (ENV_VAR, SCHEMA_VERSION, TuneCache, cache_key,
                    get_default_cache, reset, set_default_cache)
from .runner import (DeviceRow, analytic_config, autotune, autotune_into,
                     autotune_plan, backend_tag, device_kernels, device_us,
                     estimate_s, get_config, plan_jobs, time_config)
from .space import (KERNELS, ShapeSig, candidates, check_config,
                    default_config, dtype_key, effective_config,
                    sig_add_conv2d, sig_causal_conv1d, sig_conv2d,
                    sig_depthwise2d, sig_matmul, sig_maxpool2d,
                    sig_shift_conv2d, space_size)

__all__ = [
    "ENV_VAR", "SCHEMA_VERSION", "TuneCache", "cache_key",
    "get_default_cache", "reset", "set_default_cache",
    "DeviceRow", "analytic_config", "autotune", "autotune_into",
    "autotune_plan", "backend_tag", "device_kernels", "device_us",
    "estimate_s", "get_config", "plan_jobs", "time_config",
    "KERNELS", "ShapeSig", "candidates", "check_config", "default_config",
    "dtype_key", "effective_config", "sig_add_conv2d", "sig_causal_conv1d",
    "sig_conv2d", "sig_depthwise2d", "sig_matmul", "sig_maxpool2d",
    "sig_shift_conv2d", "space_size",
]
