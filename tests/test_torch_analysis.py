"""The port's static analyzer against the JAX package's, and its CUDA
launch rules.

* Parity: on each of the JAX package's fixture pairs
  (``tests/fixtures/analysis``) and on the repo's own default scan, both
  CLIs give the same exit code and the same JSON report (findings equal
  in rule, file, line, col, severity and message; equal counts).
* The port's rules are the reference's plus KL006-KL008.
* KL005 (on ``bindjoin_fused_cuda``), KL006, KL007 and KL008 each catch
  every bad variant of a small kernel tree written into ``tmp_path``
  with exactly one finding at its ``# BAD`` line, and pass the good
  ones.
* Mutations of a copy of the real ``src/repro_torch/kernels`` each give
  exactly their rule's finding; the live tree is clean and inventories
  the four CUDA entries.
"""
import ast
import json
import shutil
from pathlib import Path

import pytest

import repro.analysis as ref
from repro.analysis.__main__ import main as ref_main

import repro_torch.analysis as port
from repro_torch.analysis.__main__ import main as port_main

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
PORT_KERNELS = ROOT / "src" / "repro_torch" / "kernels"
NEW_RULES = {"KL006", "KL007", "KL008"}

ENTRIES = {
    "tpf_match_cuda": ("brtpf_tpf_match", "tpf_match.py", "tpf_match.cu"),
    "bindjoin_cuda": ("brtpf_bindjoin", "bindjoin.py", "bindjoin.cu"),
    "bindjoin_grouped_cuda": ("brtpf_bindjoin_grouped", "bindjoin.py",
                              "bindjoin.cu"),
    "bindjoin_fused_cuda": ("brtpf_bindjoin_fused", "bindjoin.py",
                            "bindjoin.cu"),
}


def _reference_cases():
    """The (stem, rule) CASES of the reference's own self-tests."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "CASES"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError("tests/test_analysis.py has no CASES")


CASES = _reference_cases()
FIXTURE_INPUTS = ([f"{stem}_{kind}.py" for stem, _ in CASES
                   for kind in ("bad", "good")]
                  + ["ac003_bad", "ac003_good"])


def _report(main, args, capsys):
    capsys.readouterr()
    rc = main([*args, "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    return rc, report


def test_reference_cases_read():
    assert len(CASES) == 15 and len(FIXTURE_INPUTS) == 32


@pytest.mark.parametrize("name", FIXTURE_INPUTS + ["<live>"])
def test_same_report_as_reference(name, capsys):
    """Same exit code, findings and counts as ``python -m repro.analysis
    --format json``; ``<live>`` is the default scan of src/ and
    benchmarks/, which is clean and inventories the four entries."""
    args = [] if name == "<live>" else [str(FIXTURES / name)]
    rc, got = _report(port_main, args, capsys)
    want_rc, want = _report(ref_main, args, capsys)
    entries = got.pop("cuda_entries")
    assert (rc, got) == (want_rc, want)
    if name == "<live>":
        assert rc == 0 and got["findings"] == []
        assert got["counts"]["modules"] > 100
        assert sorted(e["function"] for e in entries) == sorted(ENTRIES)
    else:
        assert entries == []
        assert rc == (1 if "_bad" in name else 0)
        assert len(got["findings"]) == (1 if "_bad" in name else 0)


@pytest.mark.parametrize("select", [None, "KL001", "AS001"])
def test_cli_select_matches_reference(select, capsys):
    bad = str(FIXTURES / "kl001_bad.py")
    args = [bad] + (["--select", select] if select else [])
    rc, got = _report(port_main, args, capsys)
    want_rc, want = _report(ref_main, args, capsys)
    got.pop("cuda_entries")
    assert (rc, got) == (want_rc, want)
    assert rc == (0 if select == "AS001" else 1)


def test_cli_exit_codes_and_port_rules(capsys):
    assert port_main([str(FIXTURES / "kl001_bad.py")]) == 1
    assert port_main([str(FIXTURES / "kl001_good.py")]) == 0
    assert port_main([str(FIXTURES / "kl001_bad.py"), "--select",
                      "KL006,KL007,KL008"]) == 0
    with pytest.raises(SystemExit):
        ref_main([str(FIXTURES / "kl001_bad.py"), "--select", "KL006"])
    capsys.readouterr()
    assert port_main(["--list-rules"]) == 0
    listed = {line.split()[0] for line in
              capsys.readouterr().out.splitlines()}
    assert NEW_RULES <= listed


def test_rule_ids_are_the_reference_ids_plus_cuda_rules():
    ids = [rule.rule_id for rule in port.ALL_RULES]
    assert len(ids) == len(set(ids))
    assert set(ids) == {r.rule_id for r in ref.ALL_RULES} | NEW_RULES


# -- a small kernel tree, written inline, and its variants ---------------

BUILD = '''\
import ctypes

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

SIGNATURES = {
    "widget": {
        "brtpf_widget": (_P, _P, _LL, _P),
        "brtpf_widget_pair": (_P,) * 3 + (_LL, _I) + (_P,),
    },
}


def library(name):
    return ctypes.CDLL(name)


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
'''

WIDGET_CU = '''\
// The next line is a comment, not an entry point:
// extern "C" int brtpf_ghost(void* a);
__global__ void widget_kernel(const int* x, int* y, long long t) {}

extern "C" int brtpf_widget(const void* x, void* y, long long t,
                            void* stream) {
  return 0;
}

/* a block comment
   over two lines */
extern "C" int brtpf_widget_pair(const void* a, const void* b, void* out,
                                 long long t, int k, void* stream) {
  return 0;
}
'''

WIDGET = '''\
import torch

from . import build


def widget_plain(x):
    return x + 1


def _check(name, x):
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor")


def widget_cuda(x):
    if x.device.type == "cpu":
        return widget_plain(x)
    _check("x", x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = build.library("widget")
    err = lib.brtpf_widget(x.data_ptr(), y.data_ptr(), x.numel(), None)
    build.check(err, "widget")
    return y


def widget_pair_plain(a, b):
    return a + b


def widget_pair_cuda(a, b, k):
    if a.device.type == "cpu":
        return widget_pair_plain(a, b)
    _check("a", a)
    _check("b", b)
    out = torch.empty_like(a)
    lib = build.library("widget")
    err = lib.brtpf_widget_pair(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                a.numel(), k, None)
    build.check(err, "widget_pair")
    return out
'''

OPS = '''\
from .bindjoin import bindjoin_fused_cuda


def bindjoin_fused(cand, seg_of_tile, patterns, pat_valid):
    return bindjoin_fused_cuda(cand, seg_of_tile, patterns, pat_valid)
'''

SELECTOR = '''\
from repro_torch.core.kernel_selectors import LaunchRecord
from repro_torch.kernels import ops as kops


class Selector:
    def __init__(self):
        self.launches = []

    def launch_fused(self, triples, slots, base_vecs, spans, seg_of_page):
        out = kops.bindjoin_fused_cuda(triples, None, slots, base_vecs,
                                       spans=spans, seg_of_page=seg_of_page,
                                       width=256, live=1)
        self.launches.append(LaunchRecord(
            cand_streamed=int(triples.shape[1]), pat_slots=1, groups=1,
            segments=slots.shape[0]))
        return out
'''

CUDA_TESTS = '''\
"""Cases on the card: widget_cuda, widget_pair_cuda."""
'''

TREE = {
    "kernels/build.py": BUILD,
    "kernels/csrc/widget.cu": WIDGET_CU,
    "kernels/widget.py": WIDGET,
    "kernels/ops.py": OPS,
    "core/selector.py": SELECTOR,
    "tests/test_torch_cuda.py": CUDA_TESTS,
}

# (id, rule, edits): each edit is (file, old, new), old None = new file;
# the line carrying "# BAD" is where the one finding must be.
BAD = [
    ("kl005-unrecorded", "KL005", [
        ("core/selector.py", "out = kops.bindjoin_fused_cuda(",
         "out = kops.bindjoin_fused_cuda(  # BAD"),
        ("core/selector.py", "segments=slots.shape[0]", "live=1")]),
    ("kl005-outside-the-op", "KL005", [
        ("kernels/ops.py", "def bindjoin_fused(", "def fused_tiles("),
        ("kernels/ops.py", "pat_valid)\n", "pat_valid)  # BAD\n")]),
    ("kl006-short-tuple", "KL006", [
        ("kernels/build.py", '"brtpf_widget": (_P, _P, _LL, _P),',
         '"brtpf_widget": (_P, _LL, _P),  # BAD')]),
    ("kl006-short-product", "KL006", [
        ("kernels/build.py", '(_P,) * 3 + (_LL, _I) + (_P,),',
         '(_P,) * 2 + (_LL, _I) + (_P,),  # BAD')]),
    ("kl006-table-not-literal", "KL006", [
        ("kernels/build.py", "SIGNATURES = {",
         "SIGNATURES = dict(  # BAD\n    **{"),
        ("kernels/build.py", "    },\n}\n", "    },\n})\n")]),
    ("kl006-source-not-literal", "KL006", [
        ("kernels/build.py", '    "widget": {\n', '    "widget": dict({  # BAD\n'),
        ("kernels/build.py", "    },\n}\n", "    }),\n}\n")]),
    ("kl006-not-static", "KL006", [
        ("kernels/build.py", '"brtpf_widget": (_P, _P, _LL, _P),',
         '"brtpf_widget": tuple([_P] * 4),  # BAD')]),
    ("kl006-undeclared-c-function", "KL006", [
        ("kernels/build.py",
         '        "brtpf_widget_pair": (_P,) * 3 + (_LL, _I) + (_P,),\n', ""),
        ("kernels/csrc/widget.cu", 'extern "C" int brtpf_widget_pair(',
         'extern "C" int brtpf_widget_pair(  // # BAD\n')]),
    ("kl006-missing-c-function", "KL006", [
        ("kernels/build.py", '        "brtpf_widget": (',
         '        "brtpf_widget_gone": (_P,),  # BAD\n'
         '        "brtpf_widget": (')]),
    ("kl006-source-without-table", "KL006", [
        ("kernels/csrc/extra.cu", None,
         '#include <cuda_runtime.h>\n\n'
         'extern "C" int brtpf_extra(void* x) {  // # BAD\n'
         '  return 0;\n}\n')]),
    ("kl007-unchecked-return", "KL007", [
        ("kernels/widget.py", '    build.check(err, "widget")\n', ""),
        ("kernels/widget.py", "err = lib.brtpf_widget(",
         "err = lib.brtpf_widget(  # BAD\n       ")]),
    ("kl007-return-before-check", "KL007", [
        ("kernels/widget.py",
         '    build.check(err, "widget")\n    return y\n',
         '    if err:\n        return y\n    build.check(err, "widget")\n'
         '    return y\n'),
        ("kernels/widget.py", "err = lib.brtpf_widget(",
         "err = lib.brtpf_widget(  # BAD\n       ")]),
    ("kl007-unbound-return", "KL007", [
        ("kernels/widget.py", '    build.check(err, "widget")\n', ""),
        ("kernels/widget.py", "    err = lib.brtpf_widget(",
         "    lib.brtpf_widget(  # BAD\n       ")]),
    ("kl007-unvalidated-input", "KL007", [
        ("kernels/widget.py", '    _check("b", b)\n', ""),
        ("kernels/widget.py", "err = lib.brtpf_widget_pair(",
         "err = lib.brtpf_widget_pair(  # BAD\n       ")]),
    ("kl008-no-plain-twin", "KL008", [
        ("kernels/widget.py", "def widget_plain(", "def widget_host("),
        ("kernels/widget.py", "return widget_plain(x)",
         "return widget_host(x)"),
        ("kernels/widget.py", "def widget_cuda(x):",
         "def widget_cuda(x):  # BAD")]),
    ("kl008-no-card-case", "KL008", [
        ("tests/test_torch_cuda.py", "widget_cuda, ", ""),
        ("kernels/widget.py", "def widget_cuda(x):",
         "def widget_cuda(x):  # BAD")]),
    ("kl008-misnamed-entry", "KL008", [
        ("kernels/widget.py", "def widget_cuda(x):",
         "def widget_launch(x):  # BAD")]),
]

GOOD = [
    ("base", []),
    ("kl005-op-delegates", [
        ("core/selector.py", "kops.bindjoin_fused_cuda(triples, None, ",
         "kops.bindjoin_fused(triples, None, ")]),
    ("kl006-annotated-table", [
        ("kernels/build.py", "SIGNATURES = {", "SIGNATURES: dict = {"),
        ("kernels/build.py", '"brtpf_widget": (_P, _P, _LL, _P),',
         '"brtpf_widget": (_P,) + (_P, _LL) + (_P,),')]),
    ("kl006-no-parameters", [
        ("kernels/csrc/widget.cu", "/* a block comment",
         'extern "C" int brtpf_widget_sync(void) { return 0; }\n\n'
         "/* a block comment"),
        ("kernels/build.py", '        "brtpf_widget": (',
         '        "brtpf_widget_sync": (),\n        "brtpf_widget": (')]),
    ("kl007-bare-check", [
        ("kernels/widget.py", "from . import build\n",
         "from . import build\nfrom .build import check\n"),
        ("kernels/widget.py", 'build.check(err, "widget")\n',
         'check(err, "widget")\n')]),
    ("kl008-named-beside-a-longer-name", [
        ("tests/test_torch_cuda.py", "widget_cuda, ",
         "widget_cuda_on_card (widget_cuda), ")]),
]


def _write_tree(root: Path, edits):
    files = dict(TREE)
    for name, old, new in edits:
        if old is None:
            files[name] = new
        else:
            assert files[name].count(old) == 1, (name, old)
            files[name] = files[name].replace(old, new)
    for name, text in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def _marked(root: Path, rel: str) -> int:
    for lineno, line in enumerate((root / rel).read_text().splitlines(),
                                  start=1):
        if "# BAD" in line:
            return lineno
    raise AssertionError(f"{rel} has no '# BAD' marker")


def _port_findings(root: Path):
    ctx = port.load_context([str(root)])
    return port.run_analysis(ctx), port.cuda_entries(ctx)


@pytest.mark.parametrize("case,rule,edits", BAD, ids=[b[0] for b in BAD])
def test_bad_kernel_tree_yields_one_finding(tmp_path, case, rule, edits):
    _write_tree(tmp_path, edits)
    findings, _ = _port_findings(tmp_path)
    assert len(findings) == 1, findings
    (f,) = findings
    assert (f.rule, f.severity) == (rule, port.SEVERITY_ERROR)
    assert f.line == _marked(tmp_path, f.file)


@pytest.mark.parametrize("case,edits", GOOD, ids=[g[0] for g in GOOD])
def test_good_kernel_tree_is_clean(tmp_path, case, edits):
    _write_tree(tmp_path, edits)
    findings, entries = _port_findings(tmp_path)
    assert findings == []
    assert [(e.function, e.symbol, e.source) for e in entries] == [
        ("widget_cuda", "brtpf_widget", "kernels/csrc/widget.cu"),
        ("widget_pair_cuda", "brtpf_widget_pair", "kernels/csrc/widget.cu")]


def test_reference_analyzer_misses_the_cuda_hazards(tmp_path):
    """What the new rules add: the reference finds none of them."""
    for case, _, edits in BAD:
        root = tmp_path / case
        _write_tree(root, edits)
        ctx = ref.load_context([str(root)])
        assert ref.run_analysis(ctx) == [], case


# -- mutations of the real kernels tree ----------------------------------

@pytest.fixture
def kernels_copy(tmp_path):
    """The real ``src/repro_torch/kernels`` and ``tests/test_torch_cuda.py``
    under ``tmp_path``; the analysis root is the kernels copy, and KL008
    finds the test file one level up."""
    shutil.copytree(PORT_KERNELS, tmp_path / "kernels",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "test_torch_cuda.py", tmp_path / "tests")
    return tmp_path / "kernels"


def _mutate(path: Path, old: str, new: str) -> int:
    text = path.read_text()
    assert old in text, old
    line = text[:text.index(old)].count("\n") + 1
    path.write_text(text.replace(old, new))
    return line


def test_kernels_copy_is_clean(kernels_copy):
    findings, entries = _port_findings(kernels_copy)
    assert findings == []
    assert {e.function: (e.symbol, e.module.rel, Path(e.source).name)
            for e in entries} == ENTRIES


MUTATIONS = [
    ("KL006", "build.py", '"brtpf_tpf_match": (_P, _P, _P, _LL, _P),',
     '"brtpf_tpf_match": (_P, _P, _LL, _P),', None),
    ("KL007", "bindjoin.py", '    build.check(err, "bindjoin")\n', "",
     "err = lib.brtpf_bindjoin("),
    ("KL008", "tpf_match.py", "tpf_match_plain", "tpf_match_host",
     "def tpf_match_cuda("),
]


@pytest.mark.parametrize("rule,name,old,new,anchor", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_kernels_mutation_yields_its_rule(kernels_copy, rule, name, old,
                                          new, anchor):
    path = kernels_copy / name
    line = _mutate(path, old, new)
    if anchor is not None:
        text = path.read_text()
        line = text[:text.index(anchor)].count("\n") + 1
    findings, _ = _port_findings(kernels_copy)
    assert [(f.rule, f.file, f.line) for f in findings] == [
        (rule, name, line)]


def test_live_port_tree_is_clean_with_four_entries():
    ctx = port.load_context([str(ROOT / "src" / "repro_torch")])
    assert port.run_analysis(ctx) == []
    entries = port.cuda_entries(ctx)
    assert {e.function: (e.symbol, Path(e.module.rel).name,
                         Path(e.source).name) for e in entries} == ENTRIES
    assert all(e.source == f"kernels/csrc/{ENTRIES[e.function][2]}"
               for e in entries)
