"""Typed configuration for the port: the root config tree of the preset
YAML files, `RootCfg` (counterpart of latentsplat_tpu/config/__init__.py
and config/loader.py). The dataset and view sampler configs live in
`dataset/types.py` and `dataset/view_samplers.py`, as in the JAX package.

The presets are read from the JAX package's directory, not copied. PyYAML is
not a dependency of the port, so a small reader below covers the subset the
presets use: block maps and sequences, flow lists and maps, plain and quoted
scalars resolved like PyYAML's YAML 1.1 loader, and comments.
"""

from __future__ import annotations

import dataclasses
import re
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Literal, Optional, Union

from .dataset.types import DataLoaderCfg, DatasetCfg
from .loss.losses import LossesCfg
from .model.autoencoder.identity import AutoencoderIdCfg
from .model.autoencoder.kl import AutoencoderKLCfg
from .model.decoder.splatting import DecoderSplattingCfg
from .model.encoder.backbone import BackboneDinoCfg
from .model.encoder.encoder_epipolar import EncoderEpipolarCfg

PRESET_DIR = Path(__file__).resolve().parent.parent / "latentsplat_tpu" / "config" / "presets"


# -- YAML subset reader ---------------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$"
)
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _resolve(text: str) -> Any:
    """A plain scalar, typed the way PyYAML's safe loader types it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Recursive-descent parser for one flow value ([...], {...} or scalar)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self) -> str:
        self._skip()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _expect(self, ch: str):
        if self._peek() != ch:
            raise ValueError(f"expected {ch!r} at {self.pos} in {self.text!r}")
        self.pos += 1

    def value(self, stops: str) -> Any:
        ch = self._peek()
        if ch == "[":
            self.pos += 1
            items = []
            while self._peek() != "]":
                items.append(self.value(",]"))
                if self._peek() == ",":
                    self.pos += 1
            self._expect("]")
            return items
        if ch == "{":
            self.pos += 1
            out = {}
            while self._peek() != "}":
                key = self.value(":,}")
                if self._peek() == ":":
                    self.pos += 1
                    out[key] = self.value(",}")
                else:
                    out[key] = None
                if self._peek() == ",":
                    self.pos += 1
            self._expect("}")
            return out
        if ch in "'\"":
            end = self.text.index(ch, self.pos + 1)
            value = self.text[self.pos + 1 : end]
            self.pos = end + 1
            return value.replace("''", "'") if ch == "'" else value
        # A plain scalar runs to the next stop character; a ':' stops it only
        # when followed by a space, a flow indicator or the end of the text.
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch in stops and (ch != ":" or self.text[self.pos + 1 : self.pos + 2] in ("", " ", ",", "}")):
                break
            self.pos += 1
        return _resolve(self.text[start : self.pos].strip())

    def parse(self) -> Any:
        out = self.value("" if self._peek() not in "[{" else ",]}")
        if self._peek():
            raise ValueError(f"trailing text in flow value {self.text!r}")
        return out


def _split_key(content: str) -> Optional[tuple[str, str]]:
    match = re.match(r"""((?:[^'"#:]|:(?=\S))+?)\s*:(?:\s+(.*)|$)""", content)
    if match is None:
        return None
    return match.group(1), (match.group(2) or "").strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _parse_block(lines, pos: int, indent: int):
    if _is_item(lines[pos][1]):
        items = []
        while pos < len(lines) and lines[pos][0] == indent and _is_item(lines[pos][1]):
            rest = lines[pos][1][1:].strip()
            pos += 1
            if rest:
                if _split_key(rest) and rest[0] not in "[{'\"":
                    raise ValueError(f"block mappings inside sequences are not supported: {rest!r}")
                items.append(_Flow(rest).parse())
            elif pos < len(lines) and lines[pos][0] > indent:
                value, pos = _parse_block(lines, pos, lines[pos][0])
                items.append(value)
            else:
                items.append(None)
        return items, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent and not _is_item(lines[pos][1]):
        split = _split_key(lines[pos][1])
        if split is None:
            raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
        key, rest = split
        pos += 1
        if rest:
            value = _Flow(rest).parse()
        elif pos < len(lines) and (
            lines[pos][0] > indent or (lines[pos][0] == indent and _is_item(lines[pos][1]))
        ):
            value, pos = _parse_block(lines, pos, lines[pos][0])
        else:
            value = None
        out[_resolve(key)] = value
    return out, pos


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    if len(lines) == 1 and (lines[0][1][0] in "[{'\"" or _split_key(lines[0][1]) is None):
        return _Flow(lines[0][1]).parse()
    value, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected indentation at {lines[pos][1]!r}")
    return value


def load_yaml(path: Path) -> dict:
    return parse_yaml(Path(path).read_text()) or {}


# -- config dataclasses -------------------------------------------------------


@dataclass
class DiscriminatorPatchGanCfg:
    name: str = "patch_gan"
    model: str = "kl_f8"
    base_dim: int = 64
    max_dim_mult: int = 8
    n_layers: int = 3
    downscale_factor: int = 2
    kernel_size: int = 4
    padding: int = 1
    leaky_relu_neg_slope: float = 0.2
    pretrained: bool = True


AutoencoderCfg = Union[AutoencoderKLCfg, AutoencoderIdCfg]


@dataclass
class ModelCfg:
    autoencoder: AutoencoderCfg
    encoder: EncoderEpipolarCfg
    decoder: DecoderSplattingCfg
    discriminator: Optional[DiscriminatorPatchGanCfg] = None
    encode_latents: bool = False
    supersampling_factor: int = 1
    variational: str = "none"
    remat: bool = False
    remat_policy: str = "nothing"
    compute_dtype: str = "float32"


@dataclass
class GeneratorOptimizerCfg:
    name: str = "Adam"
    lr: float = 1.5e-4
    scale_lr: bool = False
    autoencoder_lr: float = 9.0e-6
    scale_autoencoder_lr: bool = True
    autoencoder_betas: List[float] = field(default_factory=lambda: [0.5, 0.9])
    betas: List[float] = field(default_factory=lambda: [0.9, 0.999])
    warm_up_steps: int = 2000
    warm_up_start_factor: float = 5.0e-4
    gradient_clip_val: float = 0.5
    # Skip both updates when |generator total| exceeds this factor times its
    # running EMA (None: off); after `skip_loss_spike_patience` consecutive
    # skips the guard re-seeds the EMA and resumes.
    skip_loss_spike_factor: Optional[float] = None
    skip_loss_spike_patience: int = 10


@dataclass
class DiscriminatorOptimizerCfg:
    name: str = "Adam"
    lr: float = 9.0e-6
    scale_lr: bool = True
    betas: List[float] = field(default_factory=lambda: [0.5, 0.9])
    gradient_clip_val: float = 0.5


@dataclass
class OptimizerCfg:
    generator: GeneratorOptimizerCfg = field(default_factory=GeneratorOptimizerCfg)
    discriminator: Optional[DiscriminatorOptimizerCfg] = None


@dataclass
class FreezeCfg:
    autoencoder: bool = False
    encoder: bool = False
    decoder: bool = False
    discriminator: bool = False


@dataclass
class TrainCfg:
    depth_mode: Optional[str] = None
    extended_visualization: bool = False
    step_offset: int = 0
    video_interpolation: bool = False
    video_wobble: bool = False


@dataclass
class CheckpointingCfg:
    load: Optional[str] = None
    resume: bool = False
    every_n_train_steps: int = 2500
    save_top_k: int = -1


@dataclass
class TrainerCfg:
    max_steps: int = 200_001
    val_check_interval: int = 250
    log_every_n_steps: int = 50
    num_devices: Optional[int] = None


@dataclass
class TestCfg:
    output_path: str = "outputs/test"


@dataclass
class WandbCfg:
    project: str = "latentsplat_tpu"
    entity: str = ""
    name: str = "run"
    mode: str = "disabled"
    activated: bool = False
    tags: List[str] = field(default_factory=list)


@dataclass
class RootCfg:
    mode: Literal["train", "val", "test"]
    dataset: DatasetCfg
    data_loader: DataLoaderCfg
    model: ModelCfg
    optimizer: OptimizerCfg
    checkpointing: CheckpointingCfg
    trainer: TrainerCfg
    loss: LossesCfg
    test: TestCfg
    train: TrainCfg
    freeze: FreezeCfg
    seed: int
    wandb: WandbCfg = field(default_factory=WandbCfg)
    output_dir: str = "outputs"


def _is_dataclass_type(tp) -> bool:
    return dataclasses.is_dataclass(tp) and isinstance(tp, type)


def from_dict(tp, value: Any):
    """Build an instance of `tp` from plain data; unions of dataclasses
    dispatch on the value's `name` key."""
    if value is None:
        return None
    origin = typing.get_origin(tp)
    if origin is Union:
        members = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(members) == 1:
            return from_dict(members[0], value)
        if isinstance(value, dict):
            for member in members:
                if _is_dataclass_type(member) and member().name == value.get("name"):
                    return from_dict(member, value)
            if "name" in value:
                raise NotImplementedError(f"{value['name']!r} is not ported")
        return value
    if origin in (list, List):
        (item_tp,) = typing.get_args(tp) or (Any,)
        return [from_dict(item_tp, v) for v in value]
    if _is_dataclass_type(tp):
        if not isinstance(value, dict):
            raise TypeError(f"expected mapping for {tp.__name__}, got {value!r}")
        hints = typing.get_type_hints(tp)
        known = {f.name for f in dataclasses.fields(tp)}
        unknown = set(value) - known
        if unknown:
            raise ValueError(f"unknown keys {sorted(unknown)} for {tp.__name__}")
        return tp(**{k: from_dict(hints[k], v) for k, v in value.items()})
    return value


def deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        if not isinstance(node.get(k), dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def load_config(
    experiment: Optional[str] = None,
    overrides: Optional[list[str]] = None,
    base: str = "main",
    preset_dir: Path = PRESET_DIR,
) -> RootCfg:
    """presets/<base>.yaml, overlaid with presets/experiment/<experiment>.yaml
    and `a.b.c=value` overrides, as a `RootCfg`."""
    cfg = load_yaml(preset_dir / f"{base}.yaml")
    if experiment is not None:
        cfg = deep_merge(cfg, load_yaml(preset_dir / "experiment" / f"{experiment}.yaml"))
    for item in overrides or []:
        key, _, value = item.partition("=")
        set_dotted(cfg, key.strip(), parse_yaml(value))
    return from_dict(RootCfg, cfg)


__all__ = ["BackboneDinoCfg", "ModelCfg", "OptimizerCfg", "RootCfg", "load_config", "parse_yaml"]
