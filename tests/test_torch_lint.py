"""torchlint (``lightgbm_tpu_torch/tools/torchlint``), the port's static
analysis: rule firing on its fixture corpus, suppression mechanics,
baseline round trips, the CLI, the cache, injected defects in a copy of
the port, parity with jaxlint on the language-neutral JAX corpus files,
and the tier-1 gate over ``lightgbm_tpu_torch/``.

The corpus under ``tests/fixtures/torchlint_corpus/`` marks every planted
defect with ``# PLANT: TLxxx``; the tests assert the analyzer reports
exactly those (rule, line) pairs — no misses, no extras.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from lightgbm_tpu.tools import jaxlint
from lightgbm_tpu_torch.tools import torchlint
from lightgbm_tpu_torch.tools.torchlint import baseline as tl_baseline
from lightgbm_tpu_torch.tools.torchlint.cli import _build_parser
from lightgbm_tpu_torch.tools.torchlint.cli import main as torchlint_main

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "lightgbm_tpu_torch"
CORPUS = REPO / "tests" / "fixtures" / "torchlint_corpus"
JAX_CORPUS = REPO / "tests" / "fixtures" / "jaxlint_corpus"
BASELINE = PKG / "tools" / "torchlint" / "baseline.json"
PLANT_RE = re.compile(r"#\s*PLANT:\s*(TL\d{3})")

CORPUS_FILES = sorted(CORPUS.glob("*.py"))

#: the JAX corpus files of the language-neutral rules (JL005, JL006,
#: JL121, JL131, JL141, JL151, JL161)
NEUTRAL_JAX_FILES = ("set_order.py", "globals_mut.py", "lock_discipline.py",
                     "determinism.py", "concurrency.py", "fault_coverage.py",
                     "abi_parity.py")


def planted(path: Path):
    """[(rule, line)] of the ``# PLANT:`` markers in a corpus file."""
    out = []
    for i, line in enumerate(path.read_text().splitlines(), 1):
        m = PLANT_RE.search(line)
        if m:
            out.append((m.group(1), i))
    return out


@pytest.fixture(scope="module")
def package_result():
    """One analysis of the whole port (the gate's run)."""
    return torchlint.analyze_paths([str(PKG)], root=str(REPO))


# ---------------------------------------------------------------------------
# the rule set
# ---------------------------------------------------------------------------

def test_every_jaxlint_rule_has_its_torch_analog():
    assert len(torchlint.RULES) == 13
    assert sorted(c[2:] for c in torchlint.RULES) == \
        sorted(c[2:] for c in jaxlint.RULES)
    assert all(c.startswith("TL") for c in torchlint.RULES)


def test_corpus_has_plants_for_every_rule():
    rules = {r for p in CORPUS_FILES for r, _ in planted(p)}
    assert rules == set(torchlint.RULES), \
        f"corpus must exercise every shipped rule; missing " \
        f"{set(torchlint.RULES) - rules}"


@pytest.mark.parametrize("path", CORPUS_FILES, ids=lambda p: p.stem)
def test_each_planted_defect_fires_exactly_once(path):
    res = torchlint.analyze_paths([str(path)], root=str(REPO))
    assert not res.errors
    got = sorted((f.rule, f.line) for f in res.findings)
    assert got == sorted(planted(path)), \
        "findings must match the # PLANT markers exactly (rule, line)"


def test_empty_baseline_reports_whole_corpus_exactly_once():
    res = torchlint.analyze_paths([str(CORPUS)], root=str(REPO))
    new, stale = tl_baseline.apply(res.findings, {})
    got = sorted((Path(f.path).name, f.rule, f.line) for f in new)
    want = sorted((p.name, rule, line)
                  for p in CORPUS_FILES for rule, line in planted(p))
    assert got == want and not stale


# ---------------------------------------------------------------------------
# parity with jaxlint on the language-neutral JAX corpus
# ---------------------------------------------------------------------------

def _to_torchlint(text: str) -> str:
    """A JAX corpus file's directives for torchlint: ``jaxlint:`` becomes
    ``torchlint:`` and the codes its suppressions name become TL codes."""
    text = text.replace("jaxlint:", "torchlint:")
    return re.sub(r"(torchlint:\s*disable(?:-next)?\s*=\s*[A-Za-z0-9, ]*)",
                  lambda m: re.sub(r"\bJL(\d{3})", r"TL\1", m.group(1)),
                  text)


@pytest.mark.parametrize("name", NEUTRAL_JAX_FILES)
def test_parity_with_jaxlint_on_the_neutral_jax_corpus(name, tmp_path):
    src = JAX_CORPUS / name
    want = sorted((int(f.rule[2:]), f.line) for f in jaxlint.analyze_paths(
        [str(src)], root=str(REPO)).findings)
    assert want, "the JAX corpus file plants findings"
    for sib in JAX_CORPUS.glob(f"{src.stem}.*"):
        (tmp_path / sib.name).write_text(_to_torchlint(sib.read_text()))
    res = torchlint.analyze_paths([str(tmp_path / name)],
                                  root=str(tmp_path))
    assert not res.errors
    got = sorted((int(f.rule[2:]), f.line) for f in res.findings)
    assert got == want


# ---------------------------------------------------------------------------
# negative cases and suppression mechanics
# ---------------------------------------------------------------------------

def _findings_of(src, name="mod.py"):
    res = torchlint.analyze_source(src, name)
    assert not res.errors
    return res


def test_numpy_scalar_read_in_a_hot_loop_is_not_a_sync():
    src = ("# torchlint: hot-path\n"
           "import numpy as np\n"
           "def top(gain, order):\n"
           "    gain = np.asarray(gain, np.float64)\n"
           "    return [(int(f), float(gain[f]), gain[f].item())\n"
           "            for f in order]\n")
    assert not _findings_of(src).findings
    tensor = src.replace("np.asarray(gain, np.float64)",
                         "torch.as_tensor(gain)")
    tensor = tensor.replace("import numpy as np", "import torch")
    # the same reads of a tensor: float(gain[f]) and gain[f].item()
    assert [f.rule for f in _findings_of(tensor).findings] == \
        ["TL001", "TL001"]


def test_per_call_launch_geometry_is_not_a_key_input():
    """serve/packed.py's idiom: constants compared against the request's
    rows, in a module that caches nothing under a key."""
    src = ("MAX_THREADS = 256\n"
           "ROWS_PER_SM = 64\n"
           "def geometry(rows):\n"
           "    return min(MAX_THREADS, rows), rows >= ROWS_PER_SM\n")
    assert not _findings_of(src).findings
    # the same compare in a module with a graph key is a finding
    keyed = src + ("def plan_signature(num_data, config):\n"
                   "    return (num_data,)\n")
    assert [f.rule for f in _findings_of(keyed).findings] == \
        ["TL101", "TL101"]


SET_LOOP = "def f(x):\n    for v in set(x):  # {}\n        print(v)\n"


def test_unsuppressed_fixture_fires():
    assert [f.rule for f in _findings_of(SET_LOOP.format("no")).findings] \
        == ["TL005"]


def test_inline_disable_same_line():
    res = _findings_of(SET_LOOP.format("torchlint: disable=TL005"))
    assert not res.findings
    assert [f.rule for f in res.suppressed] == ["TL005"]


def test_inline_disable_wrong_code_does_not_suppress():
    res = _findings_of(SET_LOOP.format("torchlint: disable=TL001"))
    assert [f.rule for f in res.findings] == ["TL005"]


def test_jaxlint_comment_does_not_suppress_torchlint():
    res = _findings_of(SET_LOOP.format("jaxlint: disable=JL005"))
    assert [f.rule for f in res.findings] == ["TL005"]


def test_inline_disable_all():
    res = _findings_of(SET_LOOP.format("torchlint: disable=all"))
    assert not res.findings and len(res.suppressed) == 1


def test_disable_next_line():
    src = ("def f(x):\n"
           "    # torchlint: disable-next=TL005 -- order is irrelevant\n"
           "    for v in set(x):\n"
           "        print(v)\n")
    res = _findings_of(src)
    assert not res.findings and len(res.suppressed) == 1


def test_hot_path_marker_scopes_tl001():
    src = ("import torch\n"
           "def f(ts):\n"
           "    return [t.item() for t in ts]\n")
    assert not _findings_of(src).findings
    assert [f.rule for f in _findings_of(
        "# torchlint: hot-path\n" + src).findings] == ["TL001"]


# ---------------------------------------------------------------------------
# baseline round trip
# ---------------------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    res = torchlint.analyze_paths([str(CORPUS)], root=str(REPO))
    bl = tmp_path / "bl.json"
    tl_baseline.write(str(bl), res.findings)

    loaded = tl_baseline.load(str(bl))
    assert sum(loaded.values()) == len(res.findings)
    new, stale = tl_baseline.apply(res.findings, loaded)
    assert new == [] and stale == []

    # removing one entry re-exposes exactly that finding as new
    doc = json.loads(bl.read_text())
    removed = doc["entries"].pop(0)
    removed_key = (removed["file"], removed["rule"], removed["snippet"])
    bl.write_text(json.dumps(doc))
    new, stale = tl_baseline.apply(res.findings, tl_baseline.load(str(bl)))
    assert len(new) == removed["count"] and not stale
    assert all(tl_baseline.finding_key(f) == removed_key for f in new)

    # a baseline entry with no surviving finding is reported stale
    new, stale = tl_baseline.apply([], tl_baseline.load(str(bl)))
    assert not new and sum(n for _, n in stale) == len(res.findings) - \
        removed["count"]


def test_baseline_is_line_number_independent():
    src = "def f(x):\n    for v in set(x):\n        print(v)\n"
    res1 = _findings_of(src)
    res2 = _findings_of("# pad\n# pad\n" + src)
    assert res1.findings[0].line != res2.findings[0].line
    new, _ = tl_baseline.apply(
        res2.findings, {tl_baseline.finding_key(res1.findings[0]): 1})
    assert new == []


# ---------------------------------------------------------------------------
# the tier-1 gate: the port is clean, the baseline empty
# ---------------------------------------------------------------------------

def test_port_has_no_findings(package_result):
    assert not package_result.errors
    assert not package_result.findings, (
        "torchlint findings in lightgbm_tpu_torch (repair them, or "
        "suppress inline with the reason where the code is right by "
        "design):\n" + "\n".join(
            f"  {f.path}:{f.line}: {f.rule} {f.message}"
            for f in package_result.findings))


def test_committed_baseline_is_empty():
    doc = json.loads(BASELINE.read_text())
    assert doc["tool"] == "torchlint" and doc["entries"] == []
    assert tl_baseline.DEFAULT_BASELINE == str(BASELINE)


def test_every_inline_suppression_in_the_port_carries_its_reason(
        package_result):
    pattern = re.compile(r"#\s*torchlint:\s*disable(?:-next)?\s*=\s*"
                         r"[A-Za-z0-9, ]+(.*)$")
    seen = 0
    for f in sorted(PKG.rglob("*.py")):
        if "tools/torchlint" in f.as_posix():
            continue
        for i, line in enumerate(f.read_text().splitlines(), 1):
            m = pattern.search(line)
            if m:
                seen += 1
                assert len(m.group(1).strip(" -")) >= 10, \
                    f"{f}:{i}: a suppression without its reason"
    # each suppression silences the findings of one line
    lines = {(f.path, f.line) for f in package_result.suppressed}
    assert seen == len(lines) > 0


def test_analyzer_is_clean_on_itself():
    res = torchlint.analyze_paths([str(PKG / "tools")], root=str(REPO))
    assert not res.errors and not res.findings and not res.suppressed


def test_lint_and_docs_generator_import_no_jax():
    code = ("import sys\n"
            "from lightgbm_tpu_torch.tools.torchlint.cli import main\n"
            "import lightgbm_tpu_torch.utils.gen_docs\n"
            "assert main(['--list-rules']) == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgbm_tpu'))\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TL161" in out.stdout


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

def test_cli_defaults_to_the_port():
    args = _build_parser().parse_args([])
    assert args.paths == ["lightgbm_tpu_torch"] and args.baseline is None


def test_cli_list_rules(capsys):
    assert torchlint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in torchlint.RULES:
        assert code in out


def test_cli_unknown_rule_is_usage_error():
    assert torchlint_main(["--select", "TL999", str(CORPUS)]) == 2


def test_cli_json_format(capsys):
    rc = torchlint_main([str(CORPUS / "set_order.py"), "--no-baseline",
                         "--format", "json", "--root", str(REPO)])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["total"] == len(planted(CORPUS / "set_order.py"))
    assert all(f["rule"] == "TL005" for f in doc["new"])


def test_cli_select(capsys):
    rc = torchlint_main([str(CORPUS / "hot_sync.py"), "--no-baseline",
                         "--select", "TL005", "--root", str(REPO)])
    assert rc == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_explain_prints_rule_doc(capsys):
    assert torchlint_main(["--explain", "TL101"]) == 0
    out = capsys.readouterr().out
    assert "TL101" in out and "grower_key" in out


def test_cli_explain_unknown_rule():
    assert torchlint_main(["--explain", "TL999"]) == 2


def test_cli_write_baseline_round_trip(tmp_path):
    bl = tmp_path / "bl.json"
    assert torchlint_main([str(CORPUS), "--baseline", str(bl),
                           "--write-baseline", "--root", str(REPO)]) == 0
    assert torchlint_main([str(CORPUS), "--baseline", str(bl),
                           "--root", str(REPO)]) == 0


def test_cli_select_write_baseline_preserves_other_rules(tmp_path):
    bl = tmp_path / "bl.json"
    assert torchlint_main([str(CORPUS), "--baseline", str(bl),
                           "--write-baseline", "--root", str(REPO)]) == 0
    before = tl_baseline.load(str(bl))
    assert torchlint_main([str(CORPUS), "--baseline", str(bl), "--select",
                           "TL005", "--write-baseline",
                           "--root", str(REPO)]) == 0
    assert tl_baseline.load(str(bl)) == before
    assert torchlint_main([str(CORPUS), "--baseline", str(bl),
                           "--root", str(REPO)]) == 0


def test_cli_select_filters_baseline_entries(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    assert torchlint_main([str(CORPUS), "--baseline", str(bl),
                           "--write-baseline", "--root", str(REPO)]) == 0
    capsys.readouterr()
    rc = torchlint_main([str(CORPUS), "--baseline", str(bl), "--select",
                         "TL005", "--root", str(REPO)])
    out = capsys.readouterr().out
    assert rc == 0 and "stale" not in out, out


def test_cli_cache_dir_reports_warm(tmp_path, capsys):
    corpus = tmp_path / "corpus"
    shutil.copytree(CORPUS, corpus)
    cache = tmp_path / ".torchlint_cache"
    argv = [str(corpus), "--no-baseline", "--root", str(tmp_path),
            "--cache-dir", str(cache)]
    assert torchlint_main(argv) == 1
    cold = capsys.readouterr().out
    assert torchlint_main(argv) == 1
    warm = capsys.readouterr().out
    assert "[cache: warm]" in warm and "[cache: warm]" not in cold
    assert cold.splitlines()[:-1] == warm.splitlines()[:-1]


# ---------------------------------------------------------------------------
# incremental cache
# ---------------------------------------------------------------------------

def test_cache_warm_run_replays_identical_findings(tmp_path):
    corpus = tmp_path / "corpus"
    shutil.copytree(CORPUS, corpus)
    cache = tmp_path / ".torchlint_cache"
    cold = torchlint.analyze_paths([str(corpus)], root=str(tmp_path),
                                   cache_dir=str(cache))
    assert not cold.from_cache and (cache / "cache.json").exists()
    stamp = (cache / "cache.json").read_bytes()
    warm = torchlint.analyze_paths([str(corpus)], root=str(tmp_path),
                                   cache_dir=str(cache))
    assert warm.from_cache
    assert warm.cache_hits == warm.files_scanned == len(CORPUS_FILES)
    assert warm.cache_misses == 0
    dump = lambda fs: json.dumps([f.to_dict() for f in fs], sort_keys=True)
    assert dump(warm.findings) == dump(cold.findings)
    assert dump(warm.suppressed) == dump(cold.suppressed)
    # a fully warm run writes nothing
    assert (cache / "cache.json").read_bytes() == stamp


def test_cache_invalidated_by_content_change(tmp_path):
    corpus = tmp_path / "corpus"
    shutil.copytree(CORPUS, corpus)
    cache = tmp_path / ".torchlint_cache"
    torchlint.analyze_paths([str(corpus)], root=str(tmp_path),
                            cache_dir=str(cache))
    target = corpus / "set_order.py"
    target.write_text(target.read_text()
                      + "\n\ndef extra(x):\n    for v in set(x):\n"
                      "        print(v)\n")
    res = torchlint.analyze_paths([str(corpus)], root=str(tmp_path),
                                  cache_dir=str(cache))
    assert not res.from_cache and res.cache_misses == 1
    n = len(target.read_text().splitlines())
    assert any(f.path.endswith("set_order.py") and f.line == n - 1
               for f in res.findings if f.rule == "TL005")
    res2 = torchlint.analyze_paths([str(corpus)], root=str(tmp_path),
                                   cache_dir=str(cache))
    assert res2.from_cache


def test_cache_invalidated_by_abi_input_edit(tmp_path):
    """Editing only the C header a directive names must invalidate the
    project tier: directive inputs are hashed into the tree key."""
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "m.py").write_text(
        "# torchlint: abi-header=m.h\n"
        "def LGBM_Fx(a, b):\n    return 0\n")
    (proj / "m.h").write_text("int LGBM_Fx(int a, int b);\n")
    cache = tmp_path / ".torchlint_cache"
    cold = torchlint.analyze_paths([str(proj)], root=str(tmp_path),
                                   cache_dir=str(cache))
    assert not cold.findings
    warm = torchlint.analyze_paths([str(proj)], root=str(tmp_path),
                                   cache_dir=str(cache))
    assert warm.from_cache and not warm.findings
    (proj / "m.h").write_text("int LGBM_Fx(int a, int b, int c);\n")
    res = torchlint.analyze_paths([str(proj)], root=str(tmp_path),
                                  cache_dir=str(cache))
    assert not res.from_cache
    assert [f.rule for f in res.findings] == ["TL151"]


def test_cache_select_run_filters_but_never_writes(tmp_path):
    corpus = tmp_path / "corpus"
    shutil.copytree(CORPUS, corpus)
    cache = tmp_path / ".torchlint_cache"
    torchlint.analyze_paths([str(corpus)], root=str(tmp_path),
                            cache_dir=str(cache))
    stamp = (cache / "cache.json").read_bytes()
    res = torchlint.analyze_paths([str(corpus)], root=str(tmp_path),
                                  select={"TL005"}, cache_dir=str(cache))
    assert {f.rule for f in res.findings} == {"TL005"}
    assert (cache / "cache.json").read_bytes() == stamp


# ---------------------------------------------------------------------------
# project rules: injected defects in a copy of the port.  Each case
# applies its edits, lints the copy for its rule, then restores the files.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("tl1xx")
    shutil.copytree(PKG, root / "lightgbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    (root / "include" / "lightgbm_tpu").mkdir(parents=True)
    shutil.copy(REPO / "include" / "lightgbm_tpu" / "c_api.h",
                root / "include" / "lightgbm_tpu" / "c_api.h")
    (root / "src" / "capi_cuda").mkdir(parents=True)
    shutil.copy(REPO / "src" / "capi_cuda" / "lgbm_capi.cpp",
                root / "src" / "capi_cuda" / "lgbm_capi.cpp")
    return root


GROW = "lightgbm_tpu_torch/ops/grow.py"

INJECTED = {
    # INT32_SCAN_ROWS dropped from plan_signature: a grower captured under
    # one scan could be handed to a booster that needs the other
    "TL101_key_constant": ("TL101", "INT32_SCAN_ROWS", [
        (GROW, "COUNT_SPLIT_ROWS, INT32_SCAN_ROWS,\n",
         "COUNT_SPLIT_ROWS,\n")]),
    # learning_rate hashed into the key although it is written into
    # st.lr before each launch
    "TL101_launch_param": ("TL101", "learning_rate", [
        (GROW, '    "learning_rate", "grower_cache",',
         '    "grower_cache",')]),
    # an f32 upcast of the int8 stat mask upstream of the scan
    "TL111": ("TL111", "float upcast", [
        (GROW, "            m8 = st.one_f.to(torch.int8)\n",
         "            m8 = st.one_f.to(torch.int8)\n"
         "            m8 = m8.float()\n")]),
    # opposite acquisition orders of the grower-cache and plan-cache locks
    "TL121": ("TL121", "lock-order inversion", [
        (GROW, "\n\ndef _patched(grower)",
         "\n\ndef _diag(sig):\n    with _GROWER_CACHE_LOCK:\n"
         "        return stage_plan_mod.cached_plan(sig)\n"
         "\n\ndef _patched(grower)"),
        ("lightgbm_tpu_torch/ops/stage_plan.py", "\n\ndef cached_plan(",
         "\n\ndef _diag_clear():\n    from . import grow\n"
         "    with _PLAN_CACHE_LOCK:\n"
         "        return grow.clear_grower_cache()\n"
         "\n\ndef cached_plan(")]),
    # a wall-clock stamp in the pipeline checkpoint's meta payload
    "TL131": ("TL131", "wall-clock", [
        ("lightgbm_tpu_torch/pipeline/core.py",
         'meta={"policy": policy, "rows": int(rows),',
         'meta={"policy": policy, "at": time.time(), "rows": int(rows),')]),
    # the server's request event no longer names the submitter's trace
    "TL141": ("TL141", "SpanContext", [
        ("lightgbm_tpu_torch/serve/engine.py",
         "                        trace_id=ctx.trace_id,\n", "")]),
    # a binding that drops a parameter the header declares
    "TL151": ("TL151", "LGBM_ServeSwap", [
        ("lightgbm_tpu_torch/c_api.py",
         "def LGBM_ServeSwap(serve_handle, booster_handle):",
         "def LGBM_ServeSwap(serve_handle):")]),
    # a registry entry removed while the loader still arms it
    "TL161": ("TL161", "stream.parse", [
        ("lightgbm_tpu_torch/robust/faults.py",
         '"stream.parse", "net.connect",', '"net.connect",')]),
}


@pytest.mark.parametrize("case", sorted(INJECTED))
def test_injected_defect_fires_its_project_rule(port_copy, case):
    rule, needle, edits = INJECTED[case]
    originals = {}
    try:
        for rel, old, new in edits:
            p = port_copy / rel
            text = p.read_text()
            originals.setdefault(rel, text)
            assert old in text, f"{rel} no longer holds the anchor"
            p.write_text(text.replace(old, new, 1))
        res = torchlint.analyze_paths([str(port_copy / "lightgbm_tpu_torch")],
                                      root=str(port_copy), select={rule})
    finally:
        for rel, text in originals.items():
            (port_copy / rel).write_text(text)
    assert not res.errors
    assert res.findings and {f.rule for f in res.findings} == {rule}
    assert any(needle in f.message for f in res.findings), \
        [f.message for f in res.findings]
    if rule == "TL121":
        assert len(res.findings) >= 2


def test_injected_defect_cli_exit_code(port_copy, capsys):
    """The CLI over a copy of the port exits 1 once a corpus defect is
    dropped into it, and 0 without."""
    argv = [str(port_copy / "lightgbm_tpu_torch"), "--root", str(port_copy),
            "--select", "TL001,TL004"]
    assert torchlint_main(argv) == 0, capsys.readouterr().out
    bad = port_copy / "lightgbm_tpu_torch" / "_injected_bad.py"
    shutil.copy(CORPUS / "hot_sync.py", bad)
    try:
        rc = torchlint_main(argv)
    finally:
        bad.unlink()
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "_injected_bad.py" in out
