"""``chip_smoke.py``'s host-side helpers on the CPU: how the build phase
reads ptxas's report (the selective scan's float and bf16 instances
too), how the breakdowns name the SWA backward and scan kernels, the
backward's bounds, the causal forward's, the MoE generation's and the
selective scan's bounds, the new phases' cases and constants, that a
blind profiler fails the numbers phase, that every entry of the
kernels line carries the contract's keys, and the mesh phase's
tensor-parallel parts rehearsed in a gloo world on the CPU.  Nothing here needs a card or
a compiler."""
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
        "swa_bwd_dot_kernel<float>": {"registers": 31, "spill_stores": 0,
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
                            "causal": {"device_ms": 0.09},
                            "causal_llava": {"device_ms": 0.76},
                            "causal_mistral": {"device_ms": 0.5}}},
            "swa_backward": {"rows": [{"dtype": "bfloat16", "B": 1,
                                       "device_ms": device_ms}],
                             "causal_olmoe": {"device_ms": 0.4}},
            "scan": {"device_ms": 0.6, "fused": {"device_ms": 0.4},
                     "backward": {"device_ms": 2.0}},
            "hybrid": {"forward": {"device_ms": 0.4},
                       "backward": {"device_ms": 1.5}}}


def test_a_blind_profiler_fails_the_numbers_phase():
    chip_smoke._check_device_times(_numbers(2.27))
    with pytest.raises(chip_smoke.SmokeFailure, match="swa backward"):
        chip_smoke._check_device_times(_numbers(None))
    blind = _numbers(2.27)
    blind["hybrid"]["backward"]["device_ms"] = None
    with pytest.raises(chip_smoke.SmokeFailure, match="d 256"):
        chip_smoke._check_device_times(blind)
    blind = _numbers(2.27)
    blind["swa_backward"]["causal_olmoe"]["device_ms"] = None
    with pytest.raises(chip_smoke.SmokeFailure, match="causal bf16 olmoe"):
        chip_smoke._check_device_times(blind)
    blind = _numbers(2.27)
    blind["scan"]["backward"]["device_ms"] = None
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="selective scan backward"):
        chip_smoke._check_device_times(blind)


_SCAN_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121selective_scan_kernelILi16EfEEvPKfPKT0_S4_S4_xS2_S2_PfS5_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121selective_scan_kernelILi16EfEEvPKfPKT0_S4_S4_xS2_S2_PfS5_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121selective_scan_kernelILi16E13__nv_bfloat16EEvPKfPKT0_S5_S5_xS3_S3_PfS6_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121selective_scan_kernelILi16E13__nv_bfloat16EEvPKfPKT0_S5_S5_xS3_S3_PfS6_ii
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem
"""


def test_scan_instances_are_told_apart_by_state_size_and_dtype():
    """The build phase counts six scan kernels (d_state 4, 8, 16 x fp32,
    bf16): the demangler keeps their type arguments apart."""
    got = chip_smoke._ptxas_kernels(_SCAN_PTXAS)
    assert got == {
        "selective_scan_kernel<16, float>": {"registers": 128,
                                             "spill_stores": 0,
                                             "spill_loads": 0},
        "selective_scan_kernel<16, bf16>": {"registers": 128,
                                            "spill_stores": 4,
                                            "spill_loads": 4}}
    assert chip_smoke._kernel_group(
        "void (anonymous namespace)::selective_scan_kernel<16, "
        "__nv_bfloat16>(const float*)") == "selective scan"


def test_scan_source_instantiates_every_state_size():
    """Every state size, for both entry points (bare and fused, the fused
    one with and without its tile states) and both dtypes: the eighteen
    forward instances the build phase counts."""
    from repro_torch.kernels import selective_scan as tss
    text = (_build.CSRC / "selective_scan.cu").read_text()
    for st in tss.D_STATES:
        assert f"case {st}: return launch<{st}, In, FUSED>(a);" in text
    assert "dispatch<false>(c)" in text and "dispatch<true>(c)" in text
    assert "launch_kernel<ST, In, true, true>(a)" in text
    assert "launch_kernel<ST, In, FUSED, false>(a)" in text
    assert len(tss.D_STATES) * len(tss.DTYPES) * 3 == \
        chip_smoke.SCAN_INSTANCES == 18


def test_scan_instances_are_told_apart_by_entry_point():
    """The fused and bare instances differ by a bool template argument."""
    name = ("_ZN12_GLOBAL__N_121selective_scan_kernelILi16E13__nv_bfloat16"
            "Lb1EEEvNS_8ScanMapsEPKfS4_S4_PKT0_PNS_3GeoIXT_ES5_XT1_EE3OutEPfii")
    assert chip_smoke._kernel_name(name) == \
        "selective_scan_kernel<16, bf16, true>"
    assert chip_smoke._kernel_name(name.replace("Lb1E", "Lb0E")) == \
        "selective_scan_kernel<16, bf16, false>"


def test_kernel_names_read_past_a_namespace_hash():
    """An anonymous namespace's hash follows the source's path; where its
    digits read a longer span that also ends at ``_kernel``, the name is
    still the innermost one (a checkout path gave this hash's ``59``)."""
    name = ("_ZN47_GLOBAL__N__b2c59dd16_16_swa_attention_cu_2352bfab24"
            "swa_bwd_dkdv_bf16_kernelILi128EEEvPKv")
    assert chip_smoke._kernel_name(name) == "swa_bwd_dkdv_bf16_kernel<128>"


def test_sass_opcodes_are_counted_by_opcode():
    sass = """
        /*0090*/                   MUFU.EX2 R45, R45 ;   /* 0x00 */
        /*00a0*/              @!P1 FFMA R4, R12, R29, RZ ;   /* 0x00 */
        /*00b0*/                   FFMA R5, R12, R29, RZ ;   /* 0x00 */
        /*00c0*/               @P0 BRA.U.ANY 0x2620 ;   /* 0x00 */
    """
    assert chip_smoke._sass_ops(sass) == {"FFMA": 2, "MUFU": 1, "BRA": 1,
                                          "total": 4}


def test_scan_bound_at_falcon_mambas_layer():
    """One falcon-mamba-7b layer (B 2, S 2048, d_in 8192, d_state 16, bf16
    x / Bm / Cm): 537 M exps at 16 a clock on 132 SMs at 1.98 GHz, 0.128
    ms, above the ~0.101 ms of bytes: bound by operations."""
    got, by, parts = chip_smoke.scan_bound_ms(2, 2048, 8192, 16, 2)
    assert by == "operations" and round(got, 3) == 0.128
    assert round(parts["bytes"], 3) == 0.101
    assert parts["fp32"] < parts["bytes"] < parts["exp"]


def test_fused_scan_bound_at_falcon_mambas_layer():
    """The fused tail at the same layer: 537 M state exps + 101 M for
    softplus (exp, log) and silu (one tanh) on the SFUs, 0.152 ms,
    against ~270 MB (dt, x, z, out in bf16, B | C, A, D, the bias,
    h_last), 0.081 ms: bound by operations."""
    got, by, parts = chip_smoke.scan_bound_ms(2, 2048, 8192, 16, 2,
                                              fused=True)
    assert by == "operations" and round(got, 3) == 0.152
    assert round(parts["bytes"], 3) == 0.081


def test_new_phase_cases_sit_where_the_models_run():
    """The scan cases hold the zoo's state sizes and one full layer; the
    SWA phase holds whisper's decoder and one llava layer at W = S; the
    phases run at the published widths."""
    from repro_torch.models import get_config
    states = {c[3] for _, c in chip_smoke.SCAN_CASES}
    assert states == {4, 8, 16}
    assert any(c[:4] == (2, 2048, 8192, 16) and not c[4]
               for _, c in chip_smoke.SCAN_CASES)
    assert any(s % 256 and s > 256 for _, (_, s, *_) in chip_smoke.SCAN_CASES)
    swa = dict(chip_smoke.SWA_CASES)
    whisper, llava = get_config("whisper-base"), get_config("llava-next-34b")
    assert swa["causal: whisper decoder prompt, W = S"][5] == whisper.hd
    case = swa["causal: llava layer, 56 / 8 heads, W = S"]
    assert case[1:3] == (llava.n_heads, llava.n_kv_heads)
    assert case[3] == case[6] == llava.n_frontend_tokens + \
        chip_smoke.LLAVA_PROMPT
    assert chip_smoke.WHISPER_PROMPT + chip_smoke.WHISPER_STEPS <= \
        whisper.dec_len_cap


def _line_inputs():
    """The smallest phase results ``kernels_line`` reads."""
    r = dict(ms=1.0, device_ms=0.5, plain_ms=9.0, bound_ms=0.1,
             bound_by="operations", library_ms=0.8)
    swa_f = {"swa": dict(r, B=2, Hq=32, Hkv=8, S=6144, W=4096, d=80,
                         train_batch={}, causal=dict(
                             r, B=2, Hq=16, Hkv=16, S=2048, d=128,
                             library_is="SDPA"), causal_mistral=dict(
                             r, B=2, Hq=96, Hkv=8, S=2048, d=128,
                             library_is="SDPA"))}
    bwd = dict(r, B=1, dtype="bfloat16", Hq=32, Hkv=8, S=6144, W=4096, d=80,
               device_ms_by_kernel={}, design_bound_ms=0.6,
               issued_bound_ms=0.9, library_fwd_bwd_ms=7.0,
               fwd_lse_bwd_ms=2.9)
    kge_row = {f"{part}_{k}": v for part in ("forward", "backward")
               for k, v in dict(r, graph_ms=0.01).items()}
    numbers = {
        "rows": [{"N": chip_smoke.GO_ROWS, "Q": q, "k": k, "step_ms": 1.0,
                  "step_device_ms": 0.5, "step_plain_ms": 9.0,
                  "step_bound_ms": 0.1, "step_bound_by": "bytes",
                  "step_library_ms": 0.8} for q, k in ((32, 10), (1, 2000))],
        "kge": {"kge_rows": [dict(kge_row, model=m)
                             for m in ("transe_l1", "distmult")]},
        "swa": swa_f, "swa_backward": {"rows": [bwd], "causal_olmoe": dict(
            bwd, B=2, Hq=16, Hkv=16, S=2048, W=2048, d=128,
            library_is="SDPA is_causal")},
        "scan": dict(r, B=2, S=2048, d_in=8192, d_state=16, library_ms=None,
                     bound_parts_ms={}, fused=dict(
                         r, library_ms=None, bound_parts_ms={},
                         unfused_ms=1.5, unfused_device_ms=1.4,
                         without_states_ms=[0.4, 0.4],
                         with_states_ms=[0.41, 0.41]),
                     backward=dict(r, library_ms=None, bound_parts_ms={},
                                   device_ms_by_kernel={})),
        "hybrid": {"forward": dict(r, B=2, Hq=10, Hkv=1, S=4096, W=2048,
                                   d=256),
                   "backward": dict(bwd, B=2, Hq=10, Hkv=1, S=4096,
                                    W=2048, d=256)}}
    swa_l = {"swa_attention_forward": 60, "swa_attention_bwd_dot": 0,
             "swa_attention_backward_dkdv": 0,
             "swa_attention_backward_dq": 0,
             "selective_scan_forward": 0, "selective_scan_fused": 64}
    return dict(
        kern={"max_abs_err_small": 0.0, "max_abs_err_large": 0.0},
        serve_out={"launches": {e: 1 for e in chip_smoke.SMALL_ENTRY
                                + chip_smoke.LARGE_ENTRY}},
        kge={"max_abs_err_forward": 0.0, "max_abs_err_backward": 0.0},
        update_out={"kge_launches_on_path": {"kge_score_forward": 1,
                                             "kge_score_backward": 1}},
        jobs={"launches_jobs": {"small": 1, "large": 1}}, numbers=numbers,
        swa={"max_abs_err_bf16": 0.0, "max_abs_err_fp32": 0.0,
             "max_abs_err_causal": {"bfloat16": 0.0, "float32": 0.0},
             "max_abs_err_backward_bf16": 0.0,
             "max_abs_err_backward_fp32": 0.0,
             "max_abs_err_d256": {"bfloat16": 0.0, "float32": 0.0},
             "max_abs_err_backward_d256": {"bfloat16": 0.0,
                                           "float32": 0.0}},
        lm={"launches": swa_l}, moe={"launches": swa_l},
        train={"profile": {}, "launches_per_step": {}, "launches": swa_l,
               "mamba": {"launches": dict(
                   swa_l, selective_scan_fused=640,
                   selective_scan_fused_backward=320),
                   "launches_per_step": {
                       "selective_scan_fused_backward": 64}},
               "hybrid": {"launches": dict(swa_l, swa_attention_forward=48,
                                           swa_attention_bwd_dot=24,
                                           swa_attention_backward_dkdv=24,
                                           swa_attention_backward_dq=24)},
               "moe": {"launches": dict(swa_l, swa_attention_forward=96,
                                        swa_attention_bwd_dot=48,
                                        swa_attention_backward_dkdv=48,
                                        swa_attention_backward_dq=48),
                       "launches_per_step": chip_smoke._step_launches(
                           chip_smoke.MOE_ARCH, 16, 1)}},
        scan={"max_abs_err": {
            "bfloat16": {"y": 1e-5, "h_last": 1e-6, "fused_out": 0.25,
                         "fused_h_last": 5e-5, "backward": {
                             "ddt": 0.5, "dA": 1e-3,
                             "relative": {"dA": 4e-6}}},
            "float32": {"y": 3e-5, "h_last": 1e-6, "fused_out": 8e-4,
                        "fused_h_last": 7e-5, "backward": {
                            "ddt": 5e-4, "dA": 8e-4,
                            "relative": {"dA": 3e-6}}}},
            "launches": {"selective_scan_forward": 12,
                         "selective_scan_fused": 12}},
        mamba={"launches": swa_l}, whisper={"launches": swa_l},
        llava={"launches": swa_l}, hybrid={"launches": swa_l},
        zoo={"archs": {a: {"launches": dict(swa_l, swa_attention_forward=n)}
                       for a, n, _ in chip_smoke.ZOO_ARCHS}})


def test_every_kernels_line_entry_has_the_contracts_keys():
    """Every entry of the kernels line, the selective scan's included,
    carries the keys the contract names; the fused scan's launches are the
    falcon-mamba generation's (the bare entry point's none, with its scan
    phase launches beside), its backward's the falcon-mamba training
    run's, and their library times are null."""
    line = chip_smoke.kernels_line(**_line_inputs())
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for entry in line["kernels"]:
        assert keys <= set(entry), entry["name"]
        assert entry["route"] == "cuda"
        assert (chip_smoke.ROOT / entry["source"]).is_file()
    scan = [e for e in line["kernels"] if e["name"].startswith(
        "selective_scan_forward")]
    assert len(scan) == 1
    assert scan[0]["launches"] == 0 and scan[0]["library_ms"] is None
    assert scan[0]["on_main_path"] is False
    assert scan[0]["launches_scan_phase"] == 12
    assert scan[0]["max_abs_err"] == 1e-5
    fused = [e for e in line["kernels"] if e["name"].startswith(
        "selective_scan_fused (")]
    assert len(fused) == 1
    assert fused[0]["launches"] == 64 and fused[0]["library_ms"] is None
    assert fused[0]["max_abs_err"] == 0.25
    assert fused[0]["unfused_ms"] == 1.5
    assert fused[0]["launches_train"] == 640
    bwd = [e for e in line["kernels"] if e["name"].startswith(
        "selective_scan_fused_backward")]
    assert len(bwd) == 1 and bwd[0]["library_ms"] is None
    assert bwd[0]["launches"] == 320 and bwd[0]["launches_per_step"] == 64
    assert bwd[0]["max_abs_err"] == 0.5 and bwd[0]["max_abs_err_fp32"] == 8e-4
    causal = [e for e in line["kernels"] if "causal" in e["name"]][0]
    assert causal["launches_whisper"] == causal["launches_llava"] == 60
    olmoe = [e for e in line["kernels"] if e["name"].startswith(
        "swa_attention_backward (causal")]
    assert len(olmoe) == 1 and olmoe[0]["launches"] == 144
    assert olmoe[0]["launches_per_step"] == {
        "swa_attention_bwd_dot": 16, "swa_attention_backward_dkdv": 16,
        "swa_attention_backward_dq": 16}
    mistral = [e for e in line["kernels"] if "Hq=96" in e["name"]]
    assert len(mistral) == 1 and mistral[0]["launches"] == 4
    assert mistral[0]["launches_zoo"]["internlm2-20b"] == 48


def test_kernels_line_holds_the_mesh_phases_rank_shape_rows():
    """With the mesh phase's results, the line carries a row for each
    kernel at a rank's shapes, the contract's keys on each: the SWA
    forward at whisper-base's decoder layer on a rank's 4 of 8 heads and
    at h2o-danube's int8 prefill layer on a rank's 16 / 4, their launches
    the mesh phase's bf16 prefills over both ranks; whisper-base's layer
    in one process, its launches the whisper phase's prefill."""
    r = dict(ms=1.0, plain_ms=9.0, bound_ms=0.1, bound_by="operations",
             library_ms=0.8, max_abs_err=0.01, B=2, dtype="bfloat16")
    scan = dict(r, S=2048, d_in=4096, d_state=16, library_ms=None)
    rk = {"model_axis": 2, "scan_fused": scan, "scan_fused_backward": scan,
          "swa_forward_d256": dict(r, S=4096, Hq=5, Hkv=1, W=2048, d=256),
          "swa_backward_d256": dict(r, S=4096, Hq=5, Hkv=1, W=2048, d=256),
          "swa_forward_whisper": dict(r, S=64, Hq=8, Hkv=8, W=64, d=64),
          "swa_forward_whisper_rank": dict(r, S=64, Hq=4, Hkv=4, W=64,
                                           d=64),
          "swa_forward_h2o_rank": dict(r, S=6144, Hq=16, Hkv=4, W=4096,
                                       d=80)}
    ml = {k: 2 for k in (
        f"selective_scan_fused_tp_prefill_{chip_smoke.MAMBA_ARCH}",
        "selective_scan_fused_backward_tp_train",
        f"swa_attention_forward_tp_prefill_{chip_smoke.HYBRID_ARCH}",
        "swa_attention_bwd_dot_tp_train",
        "swa_attention_backward_dkdv_tp_train",
        "swa_attention_backward_dq_tp_train",
        "swa_attention_bwd_dot_train", "swa_attention_backward_dkdv_train",
        "swa_attention_backward_dq_train")}
    ml[f"swa_attention_forward_tp_prefill_{chip_smoke.WHISPER_ARCH}"] = 12
    ml["swa_attention_forward_tp_prefill_int8"] = 8
    line = chip_smoke.kernels_line(**_line_inputs(), mesh={
        "launches": ml, "rank_shape_kernels": rk})
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for entry in line["kernels"]:
        assert keys <= set(entry), entry["name"]
    by = {e["name"]: e for e in line["kernels"]}
    rank = [n for n in by if "whisper-base's decoder, a rank's" in n]
    assert len(rank) == 1 and "Hq=4 Hkv=4" in rank[0]
    assert by[rank[0]]["launches"] == 12
    h2o = [n for n in by if "int8 cache, a rank's" in n]
    assert len(h2o) == 1 and "Hq=16 Hkv=4 W=4096 d=80" in h2o[0]
    assert by[h2o[0]]["launches"] == 8
    one = [n for n in by if "decoder in one process" in n]
    assert len(one) == 1 and "Hq=8 Hkv=8" in one[0]
    assert by[one[0]]["launches"] == 60          # _line_inputs' whisper
    assert by[one[0]]["source"] == chip_smoke.SWA_SOURCE


def _stub_card(monkeypatch, failures):
    """chip_smoke on the CPU: DEV = "cpu", the card's timers stubbed by
    host ones, failed checks collected instead of raised."""
    import time
    import torch
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, msg: ok or failures.append(msg))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def host_ms(fn, iters=1, warmup=0):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    monkeypatch.setattr(chip_smoke, "_cuda_ms", host_ms)
    monkeypatch.setattr(chip_smoke, "_device_ms", lambda fn, iters=1: {
        "selective_scan_kernel": host_ms(fn)})


def test_scan_phase_rehearses_on_the_cpu(monkeypatch):
    """The scan phase's bare, fused and backward cases at the reduced
    shapes run on the CPU against the plain versions; only the checks that
    need the kernel fail (its launch counts; the bare scan's gradient that
    must raise)."""
    failures = []
    _stub_card(monkeypatch, failures)
    monkeypatch.setattr(chip_smoke, "SCAN_CASES", chip_smoke.SCAN_CASES[:4])
    out = chip_smoke.phase_scan()
    # each case: the fused forward without and with its tile states, and
    # the backward; then one gradient through SelectiveScanFusedFn
    assert out["launches"] == {"selective_scan_forward": 8,
                               "selective_scan_fused": 17,
                               "selective_scan_fused_backward": 9}
    for dtype in ("float32", "bfloat16"):
        assert set(out["max_abs_err"][dtype]) == {
            "y", "h_last", "fused_out", "fused_h_last", "backward"}
        bwd = out["max_abs_err"][dtype]["backward"]
        assert set(bwd) == {"dh0", "ddt", "dxc", "dz", "dA", "dD",
                            "ddt_bias", "dBm", "dCm", "relative"}
        assert set(bwd["relative"]) == set(chip_smoke.SCAN_BWD_REDUCED)
    assert len(failures) == 2
    assert failures[0].startswith("scan: launches")
    assert "did not raise" in failures[1]


def test_scan_numbers_fields_rehearse_on_the_cpu(monkeypatch):
    """scan_numbers at reduced falcon-mamba (the config module's CONFIG
    swapped for REDUCED, a 40-token prompt): the bare row, the fused one
    with its unfused yardstick, its time with and without its tile states
    and its bound, and the backward's row."""
    from repro_torch.configs import falcon_mamba_7b
    failures = []
    _stub_card(monkeypatch, failures)
    monkeypatch.setattr(falcon_mamba_7b, "CONFIG", falcon_mamba_7b.REDUCED)
    monkeypatch.setattr(chip_smoke, "MAMBA_PROMPT", 40)
    rec = chip_smoke.scan_numbers("cpu")
    assert (rec["S"], rec["d_in"], rec["d_state"]) == (40, 512, 8)
    fused = rec["fused"]
    for key in ("ms", "device_ms", "plain_ms", "unfused_ms",
                "unfused_device_ms", "bound_ms", "bound_by",
                "bound_parts_ms"):
        assert fused[key] is not None, key
    assert fused["library_ms"] is None and not failures
    assert len(fused["with_states_ms"]) == len(fused["without_states_ms"]) \
        == 2
    bwd = rec["backward"]
    for key in ("ms", "device_ms", "device_ms_by_kernel", "plain_ms",
                "bound_ms", "bound_by", "bound_parts_ms"):
        assert bwd[key] is not None, key
    assert bwd["library_ms"] is None


def test_scan_backward_bound_at_falcon_mambas_layer():
    """The fused scan's backward at one falcon-mamba-7b layer (B 2, S
    2048, d_in 8192, d_state 16, bf16), as training runs it: the entry
    point's inputs and outputs, ~606 MB (seven (B, S, d_in) bf16 tensors
    read or written, the saved states 134 MB), 0.181 ms at 3.35 TB/s,
    under the 0.191 ms of fp32 operations (23 a (t, channel, state), 14 a
    (t, channel)) and above the 0.160 ms of MUFU work (537 M state exps +
    4 a (t, channel)): bound by operations.  The per-cluster and
    per-sequence partials, ~69 MB written and read back (one dB | dC row
    a cluster of 128 channels), are the design's and stay out of the
    bound."""
    got, by, parts = chip_smoke.scan_bwd_bound_ms(2, 2048, 8192, 16, 2)
    assert by == "operations" and round(got, 3) == 0.191
    assert round(parts["bytes"], 3) == 0.181
    assert round(parts["exp"], 3) == 0.160
    assert round(parts["fp32"], 3) == 0.191
    assert round(parts["design_bytes"], 3) == 0.021


def test_training_launches_a_step_by_arch():
    """Under remat "full" a falcon-mamba-7b step launches the fused scan
    twice a layer and its backward once (128 and 64), no SWA kernel and
    no bare scan; h2o-danube the SWA kernels and no scan."""
    from repro_torch.models import get_config
    L = get_config(chip_smoke.MAMBA_ARCH).n_layers
    assert L == 64
    got = chip_smoke._step_launches(chip_smoke.MAMBA_ARCH, L, 1)
    assert got == {"swa_attention_forward": 0, "swa_attention_bwd_dot": 0,
                   "swa_attention_backward_dkdv": 0,
                   "swa_attention_backward_dq": 0,
                   "selective_scan_forward": 0, "selective_scan_fused": 128,
                   "selective_scan_fused_backward": 64}
    h2o = chip_smoke._step_launches(chip_smoke.LM_ARCH, 24, 2)
    assert h2o["swa_attention_forward"] == 96
    assert h2o["selective_scan_fused"] == h2o[
        "selective_scan_fused_backward"] == 0


def test_mamba_training_runs_at_the_generation_shape():
    """falcon-mamba-7b trains at its published width and depth on the
    generation run's batch and prompt length; the fp32 check at B = 1 and
    the same length, 2 layers."""
    assert (chip_smoke.MAMBA_TRAIN_BATCH, chip_smoke.MAMBA_TRAIN_SEQ) == (
        chip_smoke.MAMBA_BATCH, chip_smoke.MAMBA_PROMPT)
    assert chip_smoke.MAMBA_CHECK_BATCH == 1
    assert chip_smoke.TRAIN_CHECK_LAYERS == 2


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::selective_scan_bwd_kernel<16, "
    "__nv_bfloat16>(BwdMaps, BwdArgs)",
    "void (anonymous namespace)::selective_scan_bwd_kernel<4, float>"
    "(BwdMaps, BwdArgs)"])
def test_kernel_groups_name_the_scan_backward(kernel):
    assert chip_smoke._kernel_group(kernel) == "selective scan backward"


def test_scan_source_instantiates_the_backward_for_every_state_size():
    """The backward for every state size the wrapper takes, in both
    dtypes: the six backward instances the build phase counts."""
    from repro_torch.kernels import selective_scan as tss
    text = (_build.CSRC / "selective_scan.cu").read_text()
    for st in tss.D_STATES:
        assert f"case {st}: return launch_bwd<{st}, In>(" in text \
            or f"case {st}:\n      return launch_bwd<{st}, In>(" in text
    assert len(tss.D_STATES) * len(tss.DTYPES) == \
        chip_smoke.SCAN_BWD_INSTANCES
    assert f"constexpr int T = L * R;" in text and tss.TILE == 16
    assert "constexpr int CPB = 32;" in text
    assert tss.CHANNELS_PER_BLOCK == 32
    # the backward's partial rows: one a cluster of blocks
    assert f"constexpr int BWD_CLUSTER = {tss.BWD_CLUSTER};" in text
    assert tss.CHANNELS_PER_PARTIAL == 32 * tss.BWD_CLUSTER


# ------------------ recurrentgemma and head dim 256 ------------------- #
def test_swa_cases_hold_recurrentgemmas_layer_and_the_edges_at_d256():
    """The SWA phase holds recurrentgemma-2b's attention layer (10 q heads
    over 1 kv head, S 4,096, W 2,048, d 256) and, at d = 256, ragged S,
    q_offset with Sq < Skv, W not a multiple of the key tile, one query
    and W >= S."""
    from repro_torch.models import get_config
    cfg = get_config(chip_smoke.HYBRID_ARCH)
    cases = [c for _, c in chip_smoke.SWA_CASES if c[5] == 256]
    assert (1, cfg.n_heads, cfg.n_kv_heads, chip_smoke.HYBRID_PROMPT,
            chip_smoke.HYBRID_PROMPT, cfg.hd, cfg.hybrid.window, 0) in cases
    assert any(c[3] % 64 and c[7] == 0 for c in cases)         # ragged S
    assert any(c[7] > 0 and c[3] < c[4] for c in cases)        # q_offset
    assert any(c[6] % 64 for c in cases)                       # W % 64
    assert any(c[3] == 1 for c in cases)                       # one query
    assert any(c[6] >= c[4] for c in cases)                    # W >= S
    assert chip_smoke.HYBRID_PROMPT == 2 * cfg.hybrid.window


def test_hybrid_training_launches_a_step():
    """recurrentgemma-2b under remat "full": its 8 attention layers, each
    in a rematerialised period, launch the SWA forward twice a step and
    each backward entry point once; the 3-layer fp32 check's one; the
    RG-LRU layers launch no kernel."""
    got = chip_smoke._step_launches(chip_smoke.HYBRID_ARCH, 26, 1)
    assert got == {"swa_attention_forward": 16, "swa_attention_bwd_dot": 8,
                   "swa_attention_backward_dkdv": 8,
                   "swa_attention_backward_dq": 8,
                   "selective_scan_forward": 0, "selective_scan_fused": 0,
                   "selective_scan_fused_backward": 0}
    three = chip_smoke._step_launches(chip_smoke.HYBRID_ARCH,
                                      chip_smoke.HYBRID_CHECK_LAYERS, 1)
    assert three["swa_attention_forward"] == 2
    assert three["swa_attention_backward_dq"] == 1
    # a remainder attention layer (5 layers: rem recurrent, recurrent)
    assert chip_smoke._attention_layers(chip_smoke.HYBRID_ARCH, 5) == (1, 0)
    assert chip_smoke._attention_layers(chip_smoke.LM_ARCH, 24) == (24, 0)


def _hybrid_on_cpu(monkeypatch, failures):
    from repro_torch.configs import recurrentgemma_2b
    _stub_card(monkeypatch, failures)
    monkeypatch.setattr(recurrentgemma_2b, "CONFIG", recurrentgemma_2b.REDUCED)
    monkeypatch.setattr(chip_smoke, "HYBRID_PROMPT", 80)
    monkeypatch.setattr(chip_smoke, "HYBRID_STEPS", 2)


def test_hybrid_phase_rehearses_on_the_cpu(monkeypatch):
    """The hybrid phase on reduced recurrentgemma (its CONFIG swapped for
    REDUCED: 5 layers, W 64; an 80-token prompt): the fp32 prefill(S + 1)
    / prefill(S) + decode check at 3 layers holds, the generation reports
    the RG-LRU states, conv tails and rolling KV, and the scan's times
    come back; only the launch-count checks fail (the plain versions
    launch nothing)."""
    failures = []
    _hybrid_on_cpu(monkeypatch, failures)
    out = chip_smoke.phase_hybrid()
    assert out["fp32_consistency"]["layers"] == 3
    assert out["fp32_consistency"]["argmax_equal"]
    assert out["attention_layers"] == 1
    gen = out["generation"]
    assert gen["cache_bytes"] == (gen["lru_state_bytes"]
                                  + gen["conv_state_bytes"]
                                  + gen["kv_cache_bytes"])
    scan = out["rglru_scan"]
    assert scan["recurrent_layers"] == 4 and scan["S"] == 80
    for key in ("forward_ms", "forward_backward_ms", "prefill_ms",
                "train_step_ms"):
        assert scan[key] > 0, key
    assert len(failures) == 2
    assert failures[0].startswith("fp32 prefills launched")
    assert failures[1].startswith("generation launched")


def test_hybrid_numbers_rehearse_on_the_cpu(monkeypatch):
    """The numbers part at d = 256 on the CPU (a reduced prompt, the
    layer's head dim): the forward and backward rows carry every field
    the kernels line reads, and their bounds."""
    failures = []
    _hybrid_on_cpu(monkeypatch, failures)
    from repro_torch.configs import recurrentgemma_2b
    cfg = recurrentgemma_2b.CONFIG.with_(d_model=2560, n_heads=10)
    monkeypatch.setattr(recurrentgemma_2b, "CONFIG", cfg)
    monkeypatch.setattr(chip_smoke, "_device_ms", lambda fn, iters=1: {
        "swa_bf16_kernel": 1.0})
    monkeypatch.setattr(chip_smoke, "_busy_share", lambda fn, steps: {})
    rec = chip_smoke.hybrid_numbers("cpu")
    assert rec["forward"]["d"] == rec["backward"]["d"] == 256
    for row in (rec["forward"], rec["backward"]):
        for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by"):
            assert row[key] is not None, key
    assert rec["forward"]["library_ms"] > 0
    assert rec["backward"]["library_fwd_bwd_ms"] > 0
    assert not failures


def test_d256_bounds_at_recurrentgemmas_layer():
    """One recurrentgemma-2b attention layer (B 2, 10 q heads, S 4,096, W
    2,048, d 256): 2 x 10 x (2048 x 2049 / 2 + 2048 x 2048) = 125.8 M
    visible pairs; the forward at 4 d operations a pair is 128.9 GFLOP,
    0.130 ms at 989 TFLOP/s, the backward at 10 d 0.326 ms."""
    pairs = 2 * 10 * chip_smoke.swa_pairs(4096, 4096, 2048, 0)
    assert pairs == 2 * 10 * (2048 * 2049 // 2 + 2048 * 2048)
    assert round(pairs / 1e6, 1) == 125.8
    fwd, by = chip_smoke.swa_bound_ms(2, 10, 1, 4096, 256, 2048, 2)
    assert by == "operations" and round(fwd, 3) == 0.130
    bwd, by = chip_smoke.swa_bwd_bound_ms(2, 10, 1, 4096, 256, 2048, 2)
    assert by == "operations" and round(bwd, 3) == 0.326


def test_a_phase_ending_prints_its_seconds_to_both_streams(capsys):
    chip_smoke.ended("phase", "build", 12.5)
    out, err = capsys.readouterr()
    assert out == err == '{"ended": "phase build", "seconds": 12.5}\n'


def test_a_long_phase_prints_each_part_as_it_ends(capsys, monkeypatch):
    clock = iter([10.0, 13.5, 20.0])
    monkeypatch.setattr(chip_smoke.time, "perf_counter", lambda: next(clock))
    lap = chip_smoke.laps("update")
    lap("v1")
    lap("v2_warm")
    out, err = capsys.readouterr()
    assert out == err == (
        '{"ended": "part update v1", "seconds": 3.5}\n'
        '{"ended": "part update v2_warm", "seconds": 6.5}\n')


def test_hybrid_layers_are_read_from_the_model():
    """recurrentgemma-2b's 26 layers: 8 periods of (RG-LRU, RG-LRU,
    attention), then 2 RG-LRU layers outside them."""
    from repro_torch.models import get_config
    cfg = get_config(chip_smoke.HYBRID_ARCH)
    assert chip_smoke._hybrid_layers(cfg, "recurrent") == (16, 2)
    assert chip_smoke._hybrid_layers(cfg, "attention") == (8, 0)


# ------------------------ olmoe training, the zoo ----------------------- #
def test_olmoe_training_launches_a_step():
    """olmoe-1b-7b under remat "full": every layer's SWA forward twice a
    step (the step and its recompute), each backward entry point once;
    over the measured run's 3 steps 96 forwards and 48 of each."""
    got = chip_smoke._step_launches(chip_smoke.MOE_ARCH, 16,
                                    chip_smoke.MOE_TRAIN_STEPS)
    assert got == {"swa_attention_forward": 96, "swa_attention_bwd_dot": 48,
                   "swa_attention_backward_dkdv": 48,
                   "swa_attention_backward_dq": 48,
                   "selective_scan_forward": 0, "selective_scan_fused": 0,
                   "selective_scan_fused_backward": 0}
    assert (chip_smoke.MOE_TRAIN_BATCH, chip_smoke.MOE_TRAIN_SEQ) == (
        chip_smoke.MOE_BATCH, chip_smoke.MOE_PROMPT)


def test_causal_bounds_at_olmoes_training_and_mistrals_layer():
    """The causal backward at olmoe's training shape (B 2, 16 / 16 heads,
    S = W = 2048, d 128): 67.1 M visible pairs x 10 x 128 operations at
    989 TFLOP/s, 0.0869 ms; the causal forward at one mistral-large-123b
    layer (B 2, 96 / 8 heads): 402.8 M pairs x 4 x 128, 0.2086 ms; both
    bound by operations."""
    pairs = chip_smoke.swa_pairs(2048, 2048, 2048, 0)
    assert round(2 * 16 * pairs / 1e6, 1) == 67.1
    bwd, by = chip_smoke.swa_bwd_bound_ms(2, 16, 16, 2048, 128, 2048, 2)
    assert by == "operations" and round(bwd, 4) == 0.0869
    fwd, by = chip_smoke.swa_bound_ms(2, 96, 8, 2048, 128, 2048, 2)
    assert by == "operations" and round(fwd, 4) == 0.2086


@pytest.mark.parametrize("name,group", [
    ("adam", "adam"), ("aten::bmm", "bmm"), ("aten::mm", "mm"),
    ("aten::addmm", "mm"), ("aten::index_add_", "index_add / gather"),
    ("aten::index_select", "index_add / gather"),
    ("aten::gather", "index_add / gather"),
    ("aten::scatter_add_", "index_add / gather"), ("aten::mul_", None),
])
def test_op_groups_split_an_moe_step(name, group):
    assert chip_smoke._op_group(name) == group


def test_zoo_depths_come_from_the_specs_budget():
    """internlm2-20b whole in both runs; the three others cut, deeper in
    zoo_deep, and one layer more than zoo_deep's would pass the budget."""
    from repro_torch.models import get_config
    for arch, depth, deep in chip_smoke.ZOO_ARCHS:
        full = get_config(arch)
        assert depth <= deep <= full.n_layers
        seq = chip_smoke.ZOO_PROMPT + chip_smoke.ZOO_STEPS
        b = chip_smoke.serve_bytes(arch, deep, chip_smoke.ZOO_BATCH, seq)
        assert b["params"] + b["cache"] <= chip_smoke.ZOO_BUDGET_BYTES
        if deep < full.n_layers:
            more = chip_smoke.serve_bytes(arch, deep + 1,
                                          chip_smoke.ZOO_BATCH, seq)
            assert more["params"] + more["cache"] \
                > chip_smoke.ZOO_BUDGET_BYTES, arch
    assert chip_smoke.ZOO_ARCHS[0] == ("internlm2-20b", 48, 48)
    assert get_config(chip_smoke.MISTRAL_ARCH).n_heads == 96


def _zoo_on_cpu(monkeypatch, failures):
    """The zoo's archs at their reduced configs (each config module's
    CONFIG swapped for REDUCED), 3 and 4 layers, a 40-token prompt."""
    import importlib
    _stub_card(monkeypatch, failures)
    for arch, _, _ in chip_smoke.ZOO_ARCHS:
        mod = importlib.import_module(
            f"repro_torch.configs.{arch.replace('-', '_')}")
        monkeypatch.setattr(mod, "CONFIG", mod.REDUCED)
    monkeypatch.setattr(chip_smoke, "ZOO_ARCHS", tuple(
        (a, 3, 4) for a, _, _ in chip_smoke.ZOO_ARCHS))
    monkeypatch.setattr(chip_smoke, "ZOO_PROMPT", 40)
    monkeypatch.setattr(chip_smoke, "ZOO_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "ZOO_MOE_CHECK_PROMPT", 24)


@pytest.mark.parametrize("deep", [False, True])
def test_zoo_phase_rehearses_on_the_cpu(monkeypatch, deep):
    """The zoo phase on the reduced configs: each arch's fp32 check holds
    (grok at capacity factor 16 drops nothing), each generation runs at
    the phase's depth with serve_specs' cache bytes, beside its params;
    only the launch-count checks fail (the plain versions launch
    nothing): two an arch."""
    failures = []
    _zoo_on_cpu(monkeypatch, failures)
    out = chip_smoke.phase_zoo("cpu", deep=deep)
    assert out["phase"] == ("zoo_deep" if deep else "zoo")
    assert list(out["archs"]) == [a for a, _, _ in chip_smoke.ZOO_ARCHS]
    for arch, rec in out["archs"].items():
        assert rec["layers"] == (4 if deep else 3)
        c = rec["fp32_consistency"]
        assert c["argmax_equal"] and c["layers"] == 2
        gen = rec["generation"]
        assert gen["layers"] == rec["layers"] and gen["prompt_len"] == 40
        assert gen["cache_bytes"] == rec["serve_specs_bytes"]["cache"]
        assert rec["serve_specs_total_bytes"] == sum(
            rec["serve_specs_bytes"].values())
    grok = out["archs"]["grok-1-314b"]
    assert grok["fp32_consistency"]["dropped"] == 0
    assert grok["fp32_consistency"]["prompt"] == 24
    assert "dropped_prefill" in grok["generation"]
    assert len(failures) == 2 * len(chip_smoke.ZOO_ARCHS)
    assert all(f.split(" ", 1)[1].startswith(("fp32 prefills launched",
                                              "generation launched"))
               or f.startswith("generation launched") for f in failures)


def test_moe_training_rehearses_on_the_cpu(monkeypatch):
    """olmoe's training parts on its reduced config: the fp32 check (the
    plain Function against itself here: the same loss and gradients, no
    choice routed apart, nothing dropped at capacity factor 16), then the
    main path through ``launch.train`` and the repeated batch through a
    step whose Adam runs in its profiler range; only the launch-count
    checks fail."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import steps
    failures = []
    _stub_card(monkeypatch, failures)
    monkeypatch.setattr(olmoe_1b_7b, "CONFIG", olmoe_1b_7b.REDUCED)
    calls = []

    def busy(fn, steps):
        for _ in range(3 + steps):
            fn()
        calls.append(steps)
        return {"steps": steps}
    monkeypatch.setattr(chip_smoke, "_busy_share", busy)
    fp32 = chip_smoke._train_fp32_check(
        chip_smoke.MOE_ARCH, 1, 48, 0, sw, "SWAAttentionFn",
        chip_smoke._plain_swa_fn(), capacity_factor=chip_smoke.MOE_CHECK_CF)
    assert fp32["routes_differ"] == 0 and fp32["dropped"] == 0
    assert fp32["loss_kernel"] == fp32["loss_plain"]
    assert fp32["worst_grad_err_over_max"] == 0
    run = chip_smoke._train_main_path(chip_smoke.MOE_ARCH, 2, 32, 1, 2, 1,
                                      "cpu")
    assert len(run["repeated_batch_losses"]) == \
        3 + chip_smoke.TRAIN_REPEAT_STEPS
    assert calls == [chip_smoke.TRAIN_REPEAT_STEPS]
    assert len(run["run"]["losses"]) == 2
    assert steps.adam is not chip_smoke._annotated_adam
    assert [f.split(" ", 3)[1:3] for f in failures] == [
        ["fp32", "step"], ["training", "launched"]]


def test_routes_differ_counts_choices():
    """Two routes of 2 tokens, top-2 of 4 experts: token 1 takes expert 3
    in place of 2 in the second, so one (token, expert) choice differs,
    whatever the order of a token's choices."""
    import torch
    a = [(torch.tensor([[[0, 1], [1, 2]]]), 0)]
    b = [(torch.tensor([[[1, 0], [3, 1]]]), 0)]
    assert chip_smoke._routes_differ(a, b, 4) == 1
    assert chip_smoke._routes_differ(a, a, 4) == 0


def test_routes_records_each_layers_choices(monkeypatch):
    """``_routes`` sees the router of each of a step's first layers: the
    reduced olmoe at its own capacity factor (1.25) routes 1 x 48 tokens
    to top-2 of 4 experts a layer and drops some pairs; the recompute
    under remat "full" adds no entry."""
    import torch
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.models import build
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = olmoe_1b_7b.REDUCED.with_(dtype="float32")
    model = build(cfg).init(torch.Generator().manual_seed(0))
    model.params.requires_grad_(True)
    batch = chip_smoke._train_batch(cfg, 0, 1, 48)
    with chip_smoke._routes(cfg.n_layers) as seen:
        chip_smoke._loss_and_grads(model, batch)
    assert [tuple(idx.shape) for idx, _ in seen] == [(1, 48, 2)] * 2
    assert sum(int(n) for _, n in seen) > 0


def test_mesh_channel_parallel_parts_rehearse_on_the_cpu():
    """The mesh phase's channel-parallel parts (falcon-mamba-7b,
    recurrentgemma-2b) in a (1, 2) gloo world at the reduced configs: the
    fp32 checks hold on both ranks (each rank's half of the channels),
    the fp32 training steps match the one-process step, the bf16
    generations' bytes equal the dry run's per-device bytes and their
    second runs repeat the first, the lead rank reports the tokens equal
    to the one-process run's; only the launch counts fail (the plain
    versions launch nothing)."""
    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import run_world
    runs = run_world(ranks.chip_rec_rank, 2, backend="gloo", devices="cpu",
                     timeout_s=180)
    for rank, r in enumerate(runs):
        c_m, c_h = r["checks"]
        assert c_m["cache_shapes"] == {"h": (2, 1, 256, 8),
                                       "conv": (2, 1, 3, 256)}
        assert c_h["cache_shapes"]["periods.0.0"] == (1, 1, 128)
        assert c_h["cache_shapes"]["periods.2.0"] == (1, 1, 1, 64, 128)
        for c in (c_m, c_h):
            assert c["argmax_equal"] and c["max_abs_diff"] <= \
                chip_smoke.LM_TOL * (1 + c["max_abs_logit"])
        for t in r["train"]:
            assert t["loss"] == pytest.approx(t["want_loss"],
                                              rel=chip_smoke.TRAIN_LOSS_RTOL)
            assert t["worst_rel_err"] <= chip_smoke.TRAIN_GRAD_TOL
        for g in r["gen"]:
            assert g["bytes"] == g["dry_run_bytes"]
            assert ("one_process_equal_tokens" in g) == (rank == 0)
        assert len(r["failures"]) == 6 and all(
            "launched" in f for f in r["failures"])


def test_mesh_tensor_parallel_parts_rehearse_on_the_cpu():
    """The mesh phase's tensor-parallel parts in a (1, 2) gloo world at the
    reduced configs: the fp32 checks hold on both ranks (each rank's half
    of the KV slots and q heads), the bf16 generation's bytes equal the
    dry run's per-device bytes, its second run repeats the first, and the
    lead rank reports the tokens equal to the one-process zoo run's; only
    the SWA launch counts fail (the plain versions launch nothing)."""
    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import run_world
    from repro_torch.models import get_config
    runs = run_world(ranks.chip_tp_rank, 2, backend="gloo", devices="cpu",
                     timeout_s=180)
    for rank, r in enumerate(runs):
        for c, (arch, B, S) in zip(r["checks"], (
                (chip_smoke.MISTRAL_ARCH, 1, 24), (chip_smoke.LM_ARCH, 1,
                                                   96))):
            cfg = get_config(arch, reduced=True)
            assert (c["arch"], c["batch"], c["prompt"]) == (arch, B, S)
            assert c["argmax_equal"] and c["decode_steps"] == \
                chip_smoke.MESH_TP_CHECK_STEPS
            assert c["max_abs_diff"] <= chip_smoke.LM_TOL * (
                1 + c["max_abs_logit"])
            assert c["kv_slots_a_rank"] == cfg.groups // 2
        tp = r["tp"]
        assert tp["bytes"] == tp["dry_run_bytes"]
        assert tp["all_reduce_bytes"] == 24 * 2 * 256 * 2
        assert ("one_process_equal_tokens" in tp) == (rank == 0)
        assert len(r["failures"]) == 3 and all(
            "launched 0 SWA kernels" in f for f in r["failures"])
    lead = runs[0]["tp"]
    assert 0 <= lead["one_process_equal_tokens"] <= lead["tokens"] == 2 * 4


def test_mesh_audio_and_int8_parts_rehearse_on_the_cpu():
    """The mesh phase's audio and int8 parts in a (1, 2) gloo world at the
    reduced configs: whisper-base's fp32 check holds on both ranks (each
    rank's half of the KV slots in every cache) and its training step
    matches the one-process step; the bf16 generations' bytes equal the
    dry run's per-device bytes, their collectives are counted (whisper's
    prefill: two all_reduces an encoder layer, three a decoder layer and
    the embedding's one), and the lead rank reports the tokens against
    the one-process run's; the int8 cache's teacher-forced logits hold
    the int8 contract on the rank's int8 slots; only the launch counts
    fail (the plain versions launch nothing)."""
    import torch
    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import run_world
    from repro_torch.models import build, get_config
    runs = run_world(ranks.chip_audio_rank, 2, backend="gloo",
                     devices="cpu", timeout_s=180)
    wcfg = get_config("whisper-base", reduced=True)
    for rank, r in enumerate(runs):
        c = r["check"]
        assert c["argmax_equal"] and c["max_abs_diff"] <= \
            chip_smoke.LM_TOL * (1 + c["max_abs_logit"])
        assert c["cache_shapes"] == {
            "k": (2, 1, 2, wcfg.dec_len_cap, wcfg.hd),
            "v": (2, 1, 2, wcfg.dec_len_cap, wcfg.hd),
            "xk": (2, 1, 2, 40, wcfg.hd), "xv": (2, 1, 2, 40, wcfg.hd)}
        t = c["train"]
        assert t["loss"] == pytest.approx(t["want_loss"],
                                          rel=chip_smoke.TRAIN_LOSS_RTOL)
        assert t["worst_rel_err"] <= chip_smoke.TRAIN_GRAD_TOL
        assert t["leaves"] == len(dict(build(wcfg).init(
            torch.Generator().manual_seed(0)).params.named_parameters()))
        g = r["gen"]
        assert g["bytes"] == g["dry_run_bytes"]
        assert g["all_reduces_a_prefill"] == 2 * 2 + 3 * 2 + 1
        assert g["collectives"]["prefill"]["all_reduce_bytes"] > 0
        assert g["all_reduce_bytes"] == 2 * 40 * wcfg.d_model * 2
        assert ("one_process_equal_tokens" in g) == (rank == 0)
        q8 = r["int8"]
        a = q8["against_one_process"]
        assert a["cache_shapes"]["k"] == (2, 2, 1, 64, 64)
        assert a["cache_shapes"]["k_scale"] == (2, 2, 1, 64)
        assert q8["generation"]["bytes"] == q8["generation"]["dry_run_bytes"]
        assert q8["generation"]["kv_cache_dtype"] == "int8"
        assert r["failures"] and all("launched" in f for f in r["failures"])
