"""repro_torch's batch former and admission control (``serve/batching.py``)
on the CPU: tests/test_batching.py's 20 contracts and the batch former's
deadline contracts of tests/test_recovery.py run with their module's names
bound to the port's objects (fake clocks, no threads, no sleeps).
"""
import types

import pytest

import test_batching as ref_batching
import test_recovery as ref_recovery
from repro_torch.serve import batching

#: the JAX package's batching names, bound to the port's
PORT_NAMES = {name: getattr(batching, name) for name in (
    "BATCH", "INTERACTIVE", "SHED_QUEUE_FULL", "BatchFormer", "Barrier",
    "Batch", "LaneConfig", "RateLimiter", "TokenBucket")}

BATCHING = tuple(name for name, fn in vars(ref_batching).items()
                 if name.startswith("test_")
                 and isinstance(fn, types.FunctionType))
#: tests/test_recovery.py's batch-former deadline contracts
DEADLINES = ("test_former_culls_expired_head",
             "test_former_culls_expired_mid_prefix_at_dispatch",
             "test_former_expires_queries_behind_mutation_barrier",
             "test_former_next_deadline_tracks_head_deadline")


def _rebound(module, name):
    """``module``'s function ``name`` with every function of ``module`` (its
    helpers included) seeing the port's batching names."""
    ns = {**vars(module), **PORT_NAMES}
    for key, fn in vars(module).items():
        if isinstance(fn, types.FunctionType) and \
                fn.__module__ == module.__name__:
            ns[key] = types.FunctionType(fn.__code__, ns, key,
                                         fn.__defaults__, fn.__closure__)
    return ns[name]


def test_every_batching_contract_is_collected():
    assert len(BATCHING) == 20


@pytest.mark.parametrize("name", BATCHING)
def test_reference_batching_contract_holds_for_port(name):
    _rebound(ref_batching, name)()


@pytest.mark.parametrize("name", DEADLINES)
def test_reference_deadline_contract_holds_for_port(name):
    _rebound(ref_recovery, name)()


def test_port_batching_is_its_own_copy():
    """The rebinding above really tests the port: its classes are not the
    JAX package's."""
    from repro.serve import batching as ref
    for name, obj in PORT_NAMES.items():
        if isinstance(obj, type):
            assert obj is not getattr(ref, name)
            assert obj.__module__ == "repro_torch.serve.batching"
