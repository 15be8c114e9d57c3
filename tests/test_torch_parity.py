"""The port does all the JAX package does: every public function and class
of every ``repro`` module has a counterpart of the same name in the
matching ``repro_torch`` module, and the counterpart accepts every
parameter name the reference's takes; every file of ``examples/`` has its
``repro_torch.examples`` module.

The reference modules are found by walking the files under
``repro.__path__``: ``pkgutil.walk_packages`` alone skips the reference's
namespace packages (``repro/models``, ``repro/launch``, ...: directories
without an ``__init__.py``).  A name counts as the module's own when its
``__module__`` is that module; a counterpart with ``**kwargs`` accepts
every name.  Each exception is one entry of ``EXEMPT``, with its reason;
an entry that no longer matches anything fails.
"""
import importlib
import inspect
from pathlib import Path

import pytest

import repro

ROOT = Path(__file__).resolve().parents[1]
REF_ROOT = Path(list(repro.__path__)[0])

_INIT_KEY = ("renamed: the init functions take a torch.Generator "
             "(generator=) in place of a JAX PRNG key")
# a reference module, a public name in one (module.name) or a parameter
# of one (module.name(param)) -> why the port has no counterpart
EXEMPT = {
    # JAX-only
    "repro.utils.compat": "JAX-only: shims over jax.shard_map and the "
                          "JAX version's mesh API",
    "repro.utils.tree": "JAX-only: pytree helpers over jax.tree_util",
    "repro.core.segmentation.segment_jit": "JAX-only: jax.jit of segment "
                                           "(the port runs it eagerly)",
    "repro.core.clustering.cluster_jit": "JAX-only: jax.jit of cluster "
                                         "(the port runs it eagerly)",
    "repro.kernels.default_interpret": "JAX-only: Pallas' interpret-mode "
                                       "default (kernels.has_cuda is the "
                                       "port's device test)",
    "repro.core.distributed.run_dsc_distributed_lowerable":
        "JAX-only: the program as one jit for XLA's lowering",
    "repro.train.step.make_jitted_train_step":
        "JAX-only: a jax.jit with GSPMD shardings (the eager "
        "make_train_step takes its place)",
    "repro.tune.autotune.measure_compiled":
        "JAX-only: times an XLA-compiled call (measure_call takes its "
        "place)",
    # not applicable: they read XLA HLO, which torch never produces
    "repro.launch.dryrun": "not applicable: lowers the pod-scale programs "
                           "to XLA HLO",
    "repro.launch.hlo_analysis": "not applicable: reads XLA HLO",
    # kernel bodies: the Pallas modules, whose counterparts are the CUDA
    # sources under repro_torch/kernels/csrc, reached through each ops.py
    "repro.kernels.stjoin.stjoin": "kernel bodies: csrc/dsc_kernels.cu",
    "repro.kernels.jaccard.jaccard": "kernel bodies: csrc/dsc_kernels.cu",
    "repro.kernels.cluster.cluster": "kernel bodies: csrc/dsc_kernels.cu",
    "repro.kernels.lcss.lcss": "kernel bodies: csrc/lcss_kernels.cu",
    "repro.kernels.attention.flash": "kernel bodies: "
                                     "csrc/attention_kernels.cu",
    # renames
    "repro.checkpoint.checkpointer.load_checkpoint(shardings)":
        "renamed: JAX shardings become the device= to load onto",
    "repro.tune.autotune.plan_cache_key(jax_version)":
        "renamed: the key's last field is the torch version",
    "repro.models.layers.init_attention(key)": _INIT_KEY,
    "repro.models.layers.init_mlp(key)": _INIT_KEY,
    "repro.models.layers.init_embedding(key)": _INIT_KEY,
    "repro.models.mamba2.init_mamba_block(key)": _INIT_KEY,
    "repro.models.moe.init_moe(key)": _INIT_KEY,
    "repro.models.rwkv6.init_rwkv_block(key)": _INIT_KEY,
    "repro.models.transformer.init_dense_block(key)": _INIT_KEY,
    "repro.models.transformer.init_moe_block(key)": _INIT_KEY,
    "repro.models.transformer.init_model(key)": _INIT_KEY,
    "repro.train.step.make_train_state(key)": _INIT_KEY,
    # the earlier work's benchmark folder
    "benchmarks": "waits for the port's benchmark, a PR of its own",
}


def _reference_modules() -> list[str]:
    names = []
    for path in sorted(REF_ROOT.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        parts = path.relative_to(REF_ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(("repro",) + parts))
    return names


MODULES = _reference_modules()


def _own_names(mod) -> dict:
    """The module's public functions and classes (and jitted callables)
    defined in it."""
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and callable(v)
            and not inspect.ismodule(v)
            and getattr(v, "__module__", None) == mod.__name__}


def _params(obj):
    try:
        return inspect.signature(obj).parameters
    except (TypeError, ValueError):     # e.g. an exception class
        return None


def _gaps(name: str) -> list[str]:
    """What the port lacks of reference module ``name``, as ``EXEMPT``
    keys."""
    if name in EXEMPT:
        return [name]
    ref = importlib.import_module(name)
    try:
        port = importlib.import_module("repro_torch" + name[len("repro"):])
    except ModuleNotFoundError:
        return [name]
    gaps = []
    for attr, obj in _own_names(ref).items():
        full = f"{name}.{attr}"
        if not hasattr(port, attr):
            gaps.append(full)
            continue
        want, have = _params(obj), _params(getattr(port, attr))
        if want is None or have is None or any(
                p.kind == p.VAR_KEYWORD for p in have.values()):
            continue
        gaps += [f"{full}({p})" for p, v in want.items()
                 if p not in have and v.kind not in (v.VAR_POSITIONAL,
                                                     v.VAR_KEYWORD)]
    return gaps


@pytest.mark.parametrize("name", MODULES)
def test_module_has_its_counterpart(name):
    """Each public name of the reference module exists in the port, and
    takes every parameter name the reference's takes, or is in
    ``EXEMPT``."""
    missing = [g for g in _gaps(name) if g not in EXEMPT]
    assert not missing, f"the port lacks {missing}"


def test_every_exemption_is_used_and_has_a_reason():
    used = {"benchmarks"} | {g for n in MODULES for g in _gaps(n)}
    assert set(EXEMPT) <= used, sorted(set(EXEMPT) - used)
    assert all(isinstance(r, str) and len(r) > 10 for r in EXEMPT.values())
    assert (ROOT / "benchmarks").is_dir()


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "examples").glob("*.py")))
def test_example_has_its_counterpart(name):
    """Each reference example has a module of the same name in
    ``repro_torch.examples`` with a ``main(argv=None)``."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert list(_params(mod.main)) == ["argv"]
