"""``chip_smoke.py``'s host-side helpers on the CPU: how the build phase
reads ptxas's report, how the breakdowns name the SWA backward kernels,
the backward's bounds, the causal forward's and the MoE generation's
bounds, and that a blind profiler fails the numbers phase.  Nothing here
needs a card or a compiler."""
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import swa_attention as tswa  # noqa: E402

_MANGLED = ("_ZN12_GLOBAL__N_124swa_bwd_dkdv_bf16_kernelILi80EEEvNS_7"
            "BwdMapsEPKfS3_P13__nv_bfloat16S5_iiiiiff")
_PTXAS = f"""\
ptxas info    : Compiling entry function '{_MANGLED}' for 'sm_90a'
ptxas info    : Function properties for {_MANGLED}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118swa_bwd_dot_kernelIfEEvPKT_S3_Pfxi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118swa_bwd_dot_kernelIfEEvPKT_S3_Pfxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 31 registers, used 0 barriers, 384 bytes cmem[0]
"""


def test_ptxas_report_gives_registers_and_spills_by_kernel():
    got = chip_smoke._ptxas_kernels(_PTXAS)
    assert got == {
        "swa_bwd_dkdv_bf16_kernel<80>": {"registers": 168, "spill_stores": 8,
                                         "spill_loads": 4},
        "swa_bwd_dot_kernel": {"registers": 31, "spill_stores": 0,
                               "spill_loads": 0}}


def test_bf16_backward_kernels_are_in_the_source_for_every_head_dim():
    """The names the build phase looks for in the SASS are the source's
    kernels, and the source dispatches every head dim the wrapper
    takes."""
    text = (_build.CSRC / "swa_attention.cu").read_text()
    for name in chip_smoke.BF16_BWD_KERNELS:
        assert re.search(rf"\n{name}\(", text), name
    for d in tswa.HEAD_DIMS:
        assert f"case {d}: return launch_bwd_hd<{d}>(" in text


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::swa_bwd_dkdv_bf16_kernel<80>(BwdMaps)",
     "swa backward_dkdv"),
    ("void (anonymous namespace)::swa_bwd_dq_bf16_kernel<80>(BwdMaps)",
     "swa backward_dq"),
    ("void (anonymous namespace)::swa_bwd_dkdv_f32_kernel<80>(float)",
     "swa backward_dkdv"),
    ("void (anonymous namespace)::swa_bwd_dq_f32_kernel<80>(float)",
     "swa backward_dq"),
    ("void (anonymous namespace)::swa_bwd_dot_kernel<float>(float)",
     "swa bwd_dot"),
    ("void (anonymous namespace)::swa_bf16_kernel<80>(SwaMaps)",
     "swa forward"),
])
def test_kernel_groups_name_each_swa_kernel(kernel, group):
    assert chip_smoke._kernel_group(kernel) == group


def test_backward_bounds_at_the_training_shape():
    """One h2o-danube layer at B = 1 in bf16: the function (five
    products) 0.434 ms, the two-kernel design (seven) 0.608 ms, what the
    bf16 kernels issue (ten) 0.869 ms, all bound by operations."""
    shape = (1, 32, 8, 6144, 80, 4096, 2)
    for products, ms in ((5, 0.434), (7, 0.608), (10, 0.869)):
        got, by = chip_smoke.swa_bwd_bound_ms(*shape, products=products)
        assert by == "operations" and round(got, 3) == ms


def test_causal_forward_bound_at_olmoes_prefill_layer():
    """W = S over one olmoe-1b-7b layer (B 2, 16 heads, S 2048, d 128):
    S (S + 1) / 2 visible pairs a head, 4 d operations each, 34.4 GFLOP
    at bf16's 989 TFLOP/s: 0.0348 ms, bound by operations."""
    assert chip_smoke.swa_pairs(2048, 2048, 2048, 0) == 2048 * 2049 // 2
    got, by = chip_smoke.swa_bound_ms(2, 16, 16, 2048, 128, 2048, 2)
    assert by == "operations" and round(got, 4) == 0.0348


def test_moe_bounds_at_olmoes_full_width():
    """olmoe-1b-7b at B 2, S 2048: capacity ceil(4096 * 8 / 64 * 1.25) =
    640, the expert products 6 x 64 x 640 x 2048 x 1024 a layer, 8.25
    TFLOP over 16 layers (8.3 ms at bf16's peak); a decode step reads
    12.9 GB of expert weights (3.85 ms at 3.35 TB/s)."""
    from repro_torch.models import get_config
    b = chip_smoke.moe_bounds(get_config("olmoe-1b-7b"), 2, 2048)
    assert b["prefill_capacity"] == 640
    assert b["prefill_expert_flop"] == 6 * 64 * 640 * 2048 * 1024 * 16
    assert round(b["prefill_expert_bound_ms"], 1) == 8.3
    assert round(b["decode_weight_bytes"] / 1e9, 1) == 12.9
    assert round(b["decode_weight_read_bound_ms"], 2) == 3.85


def test_device_ms_a_call_survives_a_dropped_activity():
    """Three calls, each one run of a 2 ms kernel and two of a 10 us one:
    one activity of each name missing from the profile leaves the time
    a call unchanged."""
    full = {"dkdv_kernel": [2000.0] * 3, "fill_kernel": [10.0] * 6}
    short = {"dkdv_kernel": [2000.0] * 2, "fill_kernel": [10.0] * 5}
    want = {"dkdv_kernel": 2.0, "fill_kernel": 0.02}
    for runs in (full, short):
        got = chip_smoke._per_call_ms(runs, iters=3)
        assert got == pytest.approx(want)


def _numbers(device_ms):
    row = {"model": "transe_l1", "forward_device_ms": 0.008,
           "backward_device_ms": 0.018}
    return {"kge": {"kge_rows": [row]},
            "swa": {"swa": {"device_ms": 0.97, "fp32_device_ms": 12.7,
                            "train_batch": {"device_ms": 0.58},
                            "causal": {"device_ms": 0.09}}},
            "swa_backward": {"rows": [{"dtype": "bfloat16", "B": 1,
                                       "device_ms": device_ms}]}}


def test_a_blind_profiler_fails_the_numbers_phase():
    chip_smoke._check_device_times(_numbers(2.27))
    with pytest.raises(chip_smoke.SmokeFailure, match="swa backward"):
        chip_smoke._check_device_times(_numbers(None))
