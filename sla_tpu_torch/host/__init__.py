"""The JAX-free host layers of `sla_tpu`, loaded without `sla_tpu/__init__.py`.

This package's `__path__` is the `sla_tpu/` directory, so
`sla_tpu_torch.host.format` runs `sla_tpu/format.py` as a module of this
package and never runs `sla_tpu/__init__.py` (which imports jax). The host
layers carry the float64 byte-identity work (the native C++ runtime and its
exact Python twins), so they keep one source and are not copied.

Modules that may be reached this way — none of them imports jax:
`constants`, `errors`, `crc16`, `bitio`, `rice`, `format`, `wavio`,
`native`, `dsp.*`, `analysis.*`, `exact`, `hostref`, and `encoder` /
`decoder`, whose module-level imports are all of the former. The port
subclasses `encoder.Encoder` and `decoder.Decoder` and overrides every
method of theirs that would import jax (`sla_tpu_torch.encoder`,
`sla_tpu_torch.decoder`).

Modules that must never be reached through this package, because they
import jax: `pipeline`, `rice_device`, `kernels.*`, `parallel.*`, `debug`,
`corpus` and `cli`.
"""

import importlib.util as _util

# find_spec on a top-level name locates the package without importing it
_spec = _util.find_spec("sla_tpu")
if _spec is None or not _spec.submodule_search_locations:
    raise ImportError("sla_tpu_torch.host needs the sla_tpu package sources")
__path__ = list(_spec.submodule_search_locations)
