"""The port's lint (``repro_torch.verify.lint``) against the reference's.

The reference's fixtures for the rules the two share (RV101 falsy-or-default,
RV104 mutable-default, RV105 wallclock), the waiver, the syntax finding and
the catalog, then the port's re-scoped rules: RV103 (no torch in the
equation layer; no jax and no ``repro`` anywhere in the port), RV107 (a raw
``torch.distributed`` collective outside ``distributed/collectives.py``)
and RV108 (an axis literal in ``distributed/``). The same fixture fed to
both packages' ``lint_source`` gives the same rule code for each shared
rule, and the port's tree, ``chip_smoke.py``, its examples and scripts are
clean.
"""

from pathlib import Path

import pytest

from repro.verify.lint import lint_source as ref_lint_source
from repro_torch.verify.lint import RULES, lint_source, lint_tree, rule_catalog

ROOT = Path(__file__).resolve().parent.parent


def _rules(findings):
    return {f.rule for f in findings}


def test_rv101_falsy_cache_fixture():
    src = (
        "def save(cal, cache=None):\n"
        "    (cache or default_cache()).put_calibration(cal)\n"
    )
    assert _rules(lint_source(src, "tune/fixture.py")) == {"RV101"}
    ok = (
        "def save(cal, cache=None):\n"
        "    dest = default_cache() if cache is None else cache\n"
        "    dest.put_calibration(cal)\n"
    )
    assert lint_source(ok, "tune/fixture.py") == []


def test_rv104_mutable_default_fixture():
    assert _rules(lint_source("def f(x=[]):\n    return x\n", "core/fixture.py")) == {"RV104"}
    assert _rules(lint_source("def f(x=make()):\n    return x\n", "core/fixture.py")) == {"RV104"}


def test_rv105_wallclock_fixture():
    src = "import time\ndef f():\n    return time.perf_counter()\n"
    assert _rules(lint_source(src, "core/fixture.py")) == {"RV105"}
    assert _rules(lint_source(src, "engine/sweep.py")) == {"RV105"}  # not sanctioned here
    # the measurement layers and the two files that time on purpose are exempt
    for ok in ("tune/fixture.py", "observe/fixture.py", "launch/fixture.py",
               "engine/execute.py", "distributed/collectives.py"):
        assert lint_source(src, ok) == [], ok


@pytest.mark.parametrize("src,path", [
    ("import torch\n", "engine/plan.py"),
    ("from torch import nn\n", "core/bounds.py"),
    ("import torch.distributed as dist\n", "distributed/grid_select.py"),
    ("import jax\n", "engine/execute.py"),
    ("import jax.numpy as jnp\n", "kernels/fixture.py"),
    ("from repro import cp_als\n", "models/fixture.py"),
    ("from repro.engine.plan import choose_blocks\n", "engine/plan.py"),
    ("import repro.verify\n", "verify/fixture.py"),
])
def test_rv103_import_scope_fixture(src, path):
    assert _rules(lint_source(src, path)) == {"RV103"}


def test_rv103_allows_the_port_its_own_imports():
    assert lint_source("import torch\nimport numpy as np\n", "engine/execute.py") == []
    assert lint_source("import repro_torch\nfrom repro_torch import cp_als\n",
                       "engine/fixture.py") == []
    assert lint_source("from ..core.bounds import seq_lb\nimport math\n", "engine/plan.py") == []


@pytest.mark.parametrize("call", ["dist.all_reduce(x)", "dist.all_gather(parts, x)",
                                  "dist.reduce_scatter(o, parts)", "dist.broadcast(x, 0)",
                                  "dist.isend(x, 1)", "dist.batch_isend_irecv(ops)",
                                  "torch.distributed.all_reduce(x)"])
def test_rv107_raw_collective_fixture(call):
    src = f"import torch\nimport torch.distributed as dist\ndef f(x):\n    {call}\n"
    assert _rules(lint_source(src, "distributed/cp_als_parallel.py")) == {"RV107"}
    assert _rules(lint_source(src, "engine/fixture.py")) == {"RV107"}
    # the counted collectives' home
    assert lint_source(src, "distributed/collectives.py") == []


def test_rv107_from_import_and_set_up_calls():
    imp = "from torch.distributed import all_reduce\n"
    assert _rules(lint_source(imp, "distributed/fixture.py")) == {"RV107"}
    ok = ("import torch.distributed as dist\n"
          "def f():\n"
          "    dist.init_process_group('gloo')\n"
          "    g = dist.new_group([0, 1])\n"
          "    dist.barrier()\n"
          "    return dist.get_rank(), collectives.all_reduce(x, g)\n")
    assert lint_source(ok, "distributed/fixture.py") == []


def test_rv108_axis_literal_fixture():
    src = "def axes():\n    return ('r', 'm1')\n"
    fs = lint_source(src, "distributed/fixture.py")
    assert _rules(fs) == {"RV108"} and len(fs) == 2
    assert lint_source(src, "engine/fixture.py") == []
    assert lint_source(src, "distributed/mesh.py") == []
    assert lint_source("def f():\n    return ('ring', 'm10x')\n", "distributed/fixture.py") == []


def test_waiver_comment_suppresses_finding():
    src = "import time\ndef f():\n    return time.perf_counter()  # verify: allow=RV105\n"
    assert lint_source(src, "core/fixture.py") == []
    assert lint_source(src.replace("allow=RV105", "allow=all"), "core/fixture.py") == []
    assert _rules(lint_source(src.replace("allow=RV105", "allow=RV101"),
                              "core/fixture.py")) == {"RV105"}


def test_unparsable_module_is_a_finding():
    assert [f.rule for f in lint_source("def broken(:\n", "core/fixture.py")] == ["syntax"]


def test_rule_catalog_lists_every_rule_and_leaves_out_the_jax_ones():
    cat = rule_catalog()
    for r in RULES:
        assert r.code in cat and r.name in cat
    assert [r.code for r in RULES] == ["RV101", "RV103", "RV104", "RV105", "RV107", "RV108"]
    assert "RV102" not in cat and "RV106" not in cat


# the same fixture in both packages' lint: the same code for every shared rule
SHARED = [
    ("def save(cal, cache=None):\n    (cache or default_cache()).put(cal)\n", "tune/x.py",
     "RV101"),
    ("def f(x={}):\n    return x\n", "core/x.py", "RV104"),
    ("def f(x=set()):\n    return x\n", "core/x.py", "RV104"),
    ("import time\ndef f():\n    return time.time()\n", "core/x.py", "RV105"),
    ("import random\ndef f():\n    return random.random()\n", "engine/plan.py", "RV105"),
    ("import jax\n", "engine/plan.py", "RV103"),
    ("def f():\n    return 'm3'\n", "distributed/x.py", "RV108"),
]


@pytest.mark.parametrize("src,path,code", SHARED)
def test_shared_rules_give_the_reference_code(src, path, code):
    assert _rules(lint_source(src, path)) == _rules(ref_lint_source(src, path)) == {code}


def test_lint_tree_is_clean():
    assert lint_tree() == []


def test_chip_smoke_examples_and_scripts_import_no_jax_or_reference():
    paths = [ROOT / "chip_smoke.py", *sorted((ROOT / "examples").glob("torch_*.py")),
             *sorted((ROOT / "scripts").glob("*.py"))]
    for path in paths:
        found = [f for f in lint_source(path.read_text(), f"scripts/{path.name}")
                 if f.rule in ("RV103", "syntax")]
        assert found == [], path
