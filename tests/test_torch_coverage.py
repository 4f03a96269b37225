"""The port is complete: every public function and class of every yololite_tpu module has its counterpart.

Each module of yololite_tpu/ is parsed with `ast` (nothing of JAX is
imported) for its top-level public functions and classes, and the module of
the same path under yololite_tpu_torch/ must define, assign or import the
same name. The exceptions below are JAX-only plumbing whose job the port
does another way; each says where.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "yololite_tpu", REPO / "yololite_tpu_torch"

EXCEPTIONS = {
    # the functional optimizer's pytree forms (update rules over pytrees, their state tuple and init, the
    # param-group labels tree, the clip over a tree): the port's engine/optim.py Optimizer holds the state, every
    # rule is one tensor's update in ops/optim_kernels.py rule_update, the clip its grad_norm_plain and
    # clip_scale, applied to all tensors at once by K10
    "engine/optim.py": {"OptState", "adam_update", "adamax_update", "adamw_update", "build_group_labels",
                        "clip_by_global_norm", "init_state", "nadam_update", "radam_update", "rmsprop_update",
                        "sgd_update"},
    # pytree <-> state_dict plumbing: the port's weights are a state_dict already (state_dict_from_jax and
    # jax_trees bridge the two packages)
    "models/checkpoint.py": {"conform_tree", "pytree_to_state_dict", "state_dict_to_pytree"},
    # the resolved-row record of the functional graph: the port's rows are nn.Modules carrying i and f
    "models/model.py": {"Row"},
    # the functional module system (explicit params/state trees, the init key, the apply context, the
    # container and conv/BN primitives, the tree fuse): torch.nn modules, models/modules.py fuse_ and
    # init_weights_, ops/kernels.py quantize_act and the Detect head's own decode
    "models/modules.py": {"Conv2d", "Ctx", "KeyGen", "ModList", "Module", "Seq", "batchnorm", "conv2d",
                          "dfl_decode", "fuse_tree", "quantize_act"},
    "models/zoo.py": {"conv_transpose2d"},  # nn.ConvTranspose2d
    # the TPU's DFL forms (a custom-AD matmul, a blocked row gather): ops/decode.py dfl_expectation_mm
    "ops/decode.py": {"dfl_expectation", "dfl_expectation_mm_ad", "take_rows_blocked"},
    # the Pallas kernels and their interpret helpers: ops/kernels.py greedy_nms_keep (K1,
    # csrc/greedy_nms_keep.cu) and device_letterbox
    "ops/pallas_kernels.py": {"device_letterbox", "greedy_nms_keep_pallas"},
    # the functional EMA step: utils/ema.py ModelEMA.update, ops/optim_kernels.py ema_plain
    "utils/ema.py": {"ema_update"},
    "utils/loss.py": {"optax_sigmoid_bce"},  # utils/loss.py bce_sum
    # the TPU's blocked top-k forms that avoid a sort: ops/nms.py topk_stable
    "utils/tal.py": {"topk_blockmax_gather", "topk_hierarchical"},
}


def _defined(path: Path, public_only: bool) -> set:
    """Top-level function and class names (public ones only) or, for the port, every name bound at top level."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif not public_only and isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif not public_only and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")} if public_only else names


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py") if _defined(p, True))


@pytest.mark.parametrize("rel", MODULES)
def test_port_defines_every_public_name(rel):
    want = _defined(JAX / rel, True) - EXCEPTIONS.get(rel, set())
    port = PORT / rel
    assert port.exists() or not want, f"yololite_tpu_torch/{rel} is missing"
    missing = sorted(want - _defined(port, False)) if port.exists() else []
    assert not missing, f"yololite_tpu_torch/{rel} lacks {missing}"


def test_exceptions_are_still_needed():
    """An exception whose name the port now defines, or the JAX package no longer has, is dropped."""
    for rel, names in EXCEPTIONS.items():
        jax_names = _defined(JAX / rel, True)
        port = PORT / rel
        port_names = _defined(port, False) if port.exists() else set()
        assert names <= jax_names and not names & port_names, rel


def test_the_port_imports_nothing_of_jax():
    for p in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(m.split(".")[0] in ("jax", "jaxlib", "yololite_tpu", "flax", "optax") for m in mods), p
