"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
logic is exercised without accelerator hardware.

JAX_PLATFORMS defaults to the CPU; the ``chip``-marked tests reach the card
when it names the GPU (``JAX_PLATFORMS=cuda``, as chip_smoke.py runs them)."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    # Synchronous CPU dispatch: XLA's async CPU runner intermittently loses
    # a wakeup on small hosts with 8 forced devices (mesh tests deadlock at
    # 0% CPU inside batched_device_put waiting on a prior pjit). Dispatch
    # latency is irrelevant for tests.
    os.environ.setdefault("JAX_CPU_ENABLE_ASYNC_DISPATCH", "false")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
