"""The kernel build's bookkeeping, on the CPU (no nvcc needed): the
library's key covers the headers the sources include, and the compiler's
``-Xptxas -v`` report parses into registers and spills per kernel."""
from repro_torch.kernels import _build

TC = ("_ZN12_GLOBAL__N_125flash_attention_kernel_tcILi128EEEv"
      "14CUtensorMap_stS1_S1_S1_iiiii")
SCALAR = "_ZN12_GLOBAL__N_122flash_attention_kernelIfLi64EEEvPKT_S3_S3_PS1_lllli"
LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{TC}' for 'sm_90a'
ptxas info    : Function properties for {TC}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1536 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '{SCALAR}' for 'sm_90a'
ptxas info    : Function properties for {SCALAR}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 127 registers, 420 bytes cmem[0]
"""


def test_parse_ptxas_per_kernel():
    assert _build.parse_ptxas(LOG) == {
        TC: {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
             "registers": 168},
        SCALAR: {"stack_bytes": 8, "spill_store_bytes": 4,
                 "spill_load_bytes": 12, "registers": 127},
    }
    assert _build.parse_ptxas("") == {}


def test_library_key_covers_headers(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [s.name for s in _build._sources()] == ["a.cu"]
    before = _build._digest(_build._sources())
    assert _build._digest(_build._sources()) == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._digest(_build._sources()) != before
