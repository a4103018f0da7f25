"""Test configuration: run on the CPU backend with 8 virtual devices.

The tests run on the CPU, and the sharding tests build meshes over 8
virtual CPU devices; both settings must be made before any backend is
initialized.
"""

import os
import sys

os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS', '') + ' --xla_force_host_platform_device_count=8'

import jax

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cosmoprimo_tpu.utils import init_compilation_cache  # noqa: E402

init_compilation_cache()
