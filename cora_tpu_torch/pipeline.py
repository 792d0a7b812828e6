"""Task-pipeline framework (port of ``cora_tpu/pipeline.py``).

The caput-style authoring surface: ``Property``/``enum``/``list_type``
config descriptors, ``Task`` with its setup/process/finish lifecycle,
``PipelineStopIteration`` and an in-process runner over a list of task
specs (``Pipeline(list_of_dicts)``) or YAML (``Pipeline.from_yaml``, which
alone needs PyYAML).  Tasks exchange containers whose datasets are tensors
on the task's device.

Every task has a ``device`` property (default ``"cuda"``, which raises
without a GPU); ``Pipeline.run(device=...)`` sets it for every task.  A
``RandomTask`` draws from a ``torch.Generator`` on that device.  The JAX
package's compile cache has no counterpart here.
"""

from __future__ import annotations

import logging
from typing import Callable, List

import torch

from .device import resolve_device
from .util.profiling import stage

logger = logging.getLogger("cora_tpu_torch.pipeline")


class PipelineStopIteration(Exception):
    """Raised by a task's process() to signal it has no more output."""


class ConfigError(Exception):
    """Invalid pipeline configuration."""


class Property:
    """Declarative config attribute (caput.config.Property equivalent)."""

    def __init__(self, proptype: Callable = None, default=None, key=None):
        self.proptype = proptype if proptype is not None else (lambda x: x)
        self.default = default
        self.key = key
        self.name = None

    def __set_name__(self, owner, name):
        self.name = name
        if self.key is None:
            self.key = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.__dict__.get(self.name, self.default)

    def __set__(self, obj, value):
        obj.__dict__[self.name] = value if value is None else self.proptype(value)

    def from_config(self, obj, config):
        if self.key in config:
            self.__set__(obj, config[self.key])


def enum(options, default=None):
    """Config attribute restricted to a set of options."""

    def _check(x):
        if x not in options:
            raise ConfigError(f"Value {x!r} not in allowed options {options}")
        return x

    if default is not None and default not in options:
        raise ConfigError(f"Default {default!r} not in allowed options")
    return Property(proptype=_check, default=default)


def list_type(type_=None, default=None):
    """Config attribute holding a list of a given element type."""

    def _check(x):
        if not isinstance(x, (list, tuple)):
            raise ConfigError(f"Expected a list, got {type(x)}")
        return [type_(v) for v in x] if type_ is not None else list(x)

    return Property(proptype=_check, default=default)


class Task:
    """Base pipeline task.

    Lifecycle: ``from_config`` populates the Property attributes, ``setup``
    is called once with the products of ``requires``, then ``process`` is
    called with the products of ``in`` until the inputs are exhausted or it
    raises PipelineStopIteration.  The task's tensors live on ``device``.
    """

    done = False
    device = Property(proptype=str, default="cuda")

    def __init__(self):
        self.log = logging.getLogger(f"cora_tpu_torch.pipeline.{type(self).__name__}")
        self._count = 0

    @property
    def _dev(self) -> torch.device:
        """The resolved ``device`` (raises for cuda without a GPU)."""
        return resolve_device(self.device)

    @classmethod
    def from_config(cls, config: dict):
        self = cls()
        for klass in type(self).__mro__:
            for prop in vars(klass).values():
                if isinstance(prop, Property):
                    prop.from_config(self, config or {})
        return self

    def setup(self, *requires):
        pass

    def process(self, *inputs):
        raise NotImplementedError

    def finish(self):
        pass


class RandomTask(Task):
    """Task with a seeded ``torch.Generator`` on its device (caput
    tasklib.random equivalent); ``seed=None`` seeds it from the OS."""

    seed = Property(proptype=int, default=None)

    _rng = None

    @property
    def rng(self) -> torch.Generator:
        if self._rng is None or self._rng.device != self._dev:
            self._rng = torch.Generator(device=self._dev)
            if self.seed is None:
                self._rng.seed()
            else:
                self._rng.manual_seed(self.seed)
        return self._rng


# Alias matching the reference import structure.
ContainerTask = Task


class Pipeline:
    """In-process DAG pipeline runner.

    The config mirrors caput's::

        pipeline:
          tasks:
            - type: cora_tpu_torch.signal.lss.CalculateCorrelations
              out: corr
            - type: cora_tpu_torch.signal.lss.GenerateInitialLSS
              requires: corr
              out: initial
              params: {nside: 64, frequencies: [400.0, 500.0, 64]}

    Each entry may have ``requires`` (passed to setup), ``in`` (streams
    consumed per process call), ``out`` (the name its products are
    published under) and ``save`` (an HDF5 file name pattern with
    ``{count}``).
    """

    def __init__(self, task_specs: List[dict]):
        self.task_specs = task_specs

    @classmethod
    def from_yaml(cls, path_or_str):
        import os

        import yaml

        if isinstance(path_or_str, str) and os.path.exists(path_or_str):
            with open(path_or_str) as f:
                conf = yaml.safe_load(f)
        else:
            conf = yaml.safe_load(path_or_str)

        tasks = conf["pipeline"]["tasks"] if "pipeline" in conf else conf["tasks"]
        return cls(tasks)

    @staticmethod
    def _resolve(name: str):
        import importlib

        mod, _, klass = name.rpartition(".")
        return getattr(importlib.import_module(mod), klass)

    def run(self, device=None) -> dict:
        """Execute the pipeline; returns the dict of named products (each a
        list of the values successive process() calls produced).

        ``device`` (for example ``"cpu"``) overrides every task's own.  Each
        task's process calls are timed as the stage ``task:<class name>``
        of :mod:`cora_tpu_torch.util.profiling` when timing is enabled.
        """
        products: dict[str, list] = {}

        for spec in self.task_specs:
            cls = self._resolve(spec["type"])
            task = cls.from_config(spec.get("params", {}))
            if device is not None:
                task.device = str(device)
            dev = task._dev
            name = f"task:{cls.__name__}"

            requires = spec.get("requires", [])
            if isinstance(requires, str):
                requires = [requires]
            req_products = []
            for rname in requires:
                plist = products.get(rname, [])
                if not plist:
                    raise ConfigError(
                        f"Task {spec['type']} requires {rname!r} which has no "
                        "products yet (tasks run strictly in order)."
                    )
                req_products.append(plist[-1])
            with stage(name, dev):
                task.setup(*req_products)

            in_keys = spec.get("in", [])
            if isinstance(in_keys, str):
                in_keys = [in_keys]

            outputs = []
            try:
                if in_keys:
                    streams = [list(products.get(k, [])) for k in in_keys]
                    for items in zip(*streams):
                        with stage(name, dev):
                            outputs.append(task.process(*items))
                        task._count += 1
                else:
                    while True:
                        with stage(name, dev):
                            outputs.append(task.process())
                        task._count += 1
                        if getattr(task, "done", False):
                            break
            except PipelineStopIteration:
                pass

            task.finish()
            logger.info("%s: %d product(s)", spec["type"], len(outputs))

            out_key = spec.get("out")
            if out_key is not None:
                products.setdefault(out_key, []).extend(
                    o for o in outputs if o is not None
                )

            save_to = spec.get("save", None)
            if save_to is not None:
                for i, o in enumerate(outputs):
                    if o is not None and hasattr(o, "save"):
                        o.save(save_to.format(count=i))

        return products
