"""The port's pipeline command line (frosting_tpu_torch.cli) against the
JAX package's (frosting_tpu.cli), without running either pipeline: the
parsers' flags and defaults, and the PipelineConfig and RasterConfig that
each builds for the same flags, field by field by name. The JAX CLI builds
its config inside main(), so its statements are taken from its own source
with ast and run on the parsed flags (main itself is not called). The
per-stage commands `metrics`, `full-eval` and `convert`:
tests/test_torch_stages_cli.py; the run itself, its cache and its
outputs: tests/test_torch_pipeline.py."""

import argparse
import ast
import dataclasses
import inspect
import types

import pytest

from frosting_tpu import cli as jax_cli
from frosting_tpu import pipeline as jax_pipeline
from frosting_tpu.extract.shell import ShellConfig as JaxShellConfig
from frosting_tpu.models import frosting as jax_frosting
from frosting_tpu.raster import RasterConfig as JaxRasterConfig
from frosting_tpu.train import frosting_trainer as jax_frosting_trainer
from frosting_tpu.train import gs_trainer as jax_gs_trainer
from frosting_tpu.train import sugar_trainer as jax_sugar_trainer
from frosting_tpu_torch import cli

# RasterConfig fields of the JAX package's TPU paths only (its Pallas
# backend and interpret mode, tile grouping, DMA blocks, decode flag and
# bf16 gradient sort); every other config field is in both packages
JAX_ONLY = {"RasterConfig": {"backend", "pallas_interpret", "tiles_per_program",
                             "dma_superblock", "decode", "bwd_sort_bf16"}}
FLAGS = {
    "default": [],
    "tiny": ["--tiny"],
    "low-poly-sdf-short": ["--low-poly", "-r", "sdf", "--refinement-time", "short"],
    "learn-shell": ["--learn-shell", "--regularize-shell", "-n", "0.3"],
}


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_flags_and_defaults_match_jax():
    got, want = _actions(cli.build_parser()), _actions(jax_cli.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.type, b.choices, b.required, b.nargs,
                type(b)) == (a.option_strings, a.default, a.type, a.choices, a.required,
                             a.nargs, type(a)), dest
    assert got["device"].option_strings == ["--device"] and got["device"].default == "cuda"


def _jax_configs(argv, width, height, spatial_extent):
    """(PipelineConfig, RasterConfig) of JAX's main for argv: its
    statements from `max_inst = ...` through the `if args.tiny:` branch,
    run on the parsed flags."""
    fn = next(n for n in ast.parse(inspect.getsource(jax_cli)).body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    first = next(i for i, s in enumerate(fn.body)
                 if isinstance(s, ast.Assign) and isinstance(s.targets[0], ast.Name)
                 and s.targets[0].id == "max_inst")
    last = next(i for i, s in enumerate(fn.body) if isinstance(s, ast.If))
    code = compile(ast.Module(body=fn.body[first:last + 1], type_ignores=[]), "jax_cli", "exec")
    ns = {
        "args": jax_cli.build_parser().parse_args(argv), "w": width, "h": height,
        "scene": types.SimpleNamespace(spatial_extent=spatial_extent),
        "RasterConfig": JaxRasterConfig, "pipeline": jax_pipeline, "ShellConfig": JaxShellConfig,
        "frosting_lib": jax_frosting, "gs_trainer": jax_gs_trainer,
        "sugar_trainer": jax_sugar_trainer, "frosting_trainer": jax_frosting_trainer,
    }
    exec(code, ns)
    return ns["cfg"], ns["rcfg"]


def _compare(got, want, path, only):
    """Every field of two config dataclasses, by name, recursively; the
    names only one of them has go into only[class name]."""
    names_got = {f.name for f in dataclasses.fields(got)}
    names_want = {f.name for f in dataclasses.fields(want)}
    only.setdefault(type(want).__name__, set()).update(names_want ^ names_got)
    for name in sorted(names_got & names_want):
        a, b = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(b):
            assert type(a).__name__ == type(b).__name__, f"{path}.{name}"
            _compare(a, b, f"{path}.{name}", only)
        else:
            assert a == b and type(a) is type(b), (f"{path}.{name}", a, b)


@pytest.mark.parametrize("case", FLAGS)
def test_configs_match_jax_field_by_field(case):
    argv = ["-s", "scene", *FLAGS[case]]
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    got = cli.build_config(args, 2.75)
    want, want_rcfg = _jax_configs(argv, 64, 48, 2.75)
    only = {}
    _compare(got, want, "PipelineConfig", only)
    _compare(cli.raster_config(args, 64, 48), want_rcfg, "RasterConfig", only)
    assert {k: v for k, v in only.items() if v} == JAX_ONLY
