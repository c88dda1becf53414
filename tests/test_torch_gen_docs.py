"""The port's parameter docs generator (``lightgbm_tpu_torch/utils/
gen_docs.py``) and its schema against the JAX package's:

* the committed ``docs/PortParameters.md`` is what ``render()`` writes,
  and a drifted copy is caught and rewritten;
* it has the JAX package's ``docs/Parameters.md`` sections in its order,
  every parameter line formatted alike, and marks the five
  ``IGNORED_PARAMS`` as accepted and ignored;
* the two ``PARAM_SCHEMA``s hold the same names in the same order, with
  the same aliases, types, sections, checks and defaults but
  ``device_type``'s (``tpu`` there, ``cuda`` here), and differ in the
  descriptions of exactly the parameters listed here.
"""

import re
from pathlib import Path

import pytest

from lightgbm_tpu import params as jparams
from lightgbm_tpu.utils import gen_docs as jgen_docs
from lightgbm_tpu_torch import params as tparams
from lightgbm_tpu_torch.utils import gen_docs

REPO = Path(__file__).resolve().parents[1]
DOC = REPO / "docs" / "PortParameters.md"

#: the parameters whose descriptions the port rewrote for the card
PORT_DESCRIPTIONS = ("device_type", "wave_plan", "device_growth",
                     "compile_cache_dir", "fused_chunk")


def test_committed_port_parameters_doc_is_fresh():
    assert DOC.read_text() == gen_docs.render(), (
        "docs/PortParameters.md is stale; regenerate with `python -m "
        "lightgbm_tpu_torch.utils.gen_docs docs/PortParameters.md`")


def test_drifted_copy_is_caught_and_rewritten(tmp_path, capsys):
    doc = tmp_path / "PortParameters.md"
    doc.write_text(DOC.read_text().replace("default = `31`",
                                           "default = `32`", 1))
    assert doc.read_text() != gen_docs.render()
    assert gen_docs.main([str(doc)]) == 0
    assert doc.read_text() == gen_docs.render()
    assert "wrote" in capsys.readouterr().out


def test_header_names_the_port_schema_and_command():
    head = gen_docs.render().split("\n## ", 1)[0]
    assert "`lightgbm_tpu_torch/params.py`" in head
    assert "python -m lightgbm_tpu_torch.utils.gen_docs " \
        "docs/PortParameters.md" in head


def test_same_sections_and_line_format_as_the_jax_docs():
    port, jax = gen_docs.render(), jgen_docs.render()
    heads = lambda text: re.findall(r"^## .*$", text, re.M)
    assert heads(port) == heads(jax)
    param = re.compile(r"^- `(\w+)` : ", re.M)
    assert param.findall(port) == param.findall(jax)
    # every line but the title, the header, the port's descriptions and
    # the ignored-parameter notes is the JAX document's
    body = lambda text: text.split("\n## ", 1)[1]
    port_lines = [l for l in body(port).splitlines()
                  if "accepted and ignored by the port" not in l]
    jax_lines = body(jax).splitlines()
    assert len(port_lines) == len(jax_lines)
    differ = [(a, b) for a, b in zip(port_lines, jax_lines) if a != b]
    # device_type's default line, and the listed descriptions
    assert len(differ) == 1 + len(PORT_DESCRIPTIONS)
    assert any(a.startswith("- `device_type` : ") for a, _ in differ)


@pytest.mark.parametrize("name", sorted(tparams.IGNORED_PARAMS))
def test_ignored_params_are_marked(name):
    text = gen_docs.render()
    block = text.split(f"- `{name}` : ", 1)[1].split("\n- `", 1)[0]
    assert "accepted and ignored by the port" in block


def test_ignored_params_are_the_five_tpu_knobs():
    assert sorted(tparams.IGNORED_PARAMS) == [
        "compile_cache_min_entry_bytes", "compile_cache_strict_keys",
        "find_best_fusion", "hist_kernel", "tpu_rows_per_block"]
    assert gen_docs.render().count("accepted and ignored by the port") \
        == len(tparams.IGNORED_PARAMS)


def test_schema_parity_with_the_jax_package():
    jax = {p.name: p for p in jparams.PARAM_SCHEMA}
    port = {p.name: p for p in tparams.PARAM_SCHEMA}
    assert list(port) == list(jax)
    for name, p in port.items():
        q = jax[name]
        assert (p.aliases, p.type, p.section, p.check) == \
            (q.aliases, q.type, q.section, q.check), name
        if name == "device_type":
            assert (q.default, p.default) == ("tpu", "cuda")
        else:
            assert p.default == q.default, name
    assert tparams.PARAM_ALIASES == jparams.PARAM_ALIASES


def test_descriptions_differ_only_where_listed():
    jax = {p.name: p.desc for p in jparams.PARAM_SCHEMA}
    differ = sorted(p.name for p in tparams.PARAM_SCHEMA
                    if p.desc != jax[p.name])
    assert differ == sorted(PORT_DESCRIPTIONS)
