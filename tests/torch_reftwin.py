"""Run the reference's own test files against hdk_tpu_torch.

A twin file (``tests/test_torch_<name>.py``) does
``from test_<name> import *``: pytest collects every test and fixture of
the reference's file there, with its own parametrisation, and each runs
unchanged, on the reference's data and against the reference's oracle.
The twin's autouse fixture ``device`` (``twin_module``) runs them once
on each device inside ``port_context``, which points every name the
reference module holds from ``hdk_tpu`` (the package, a submodule, a
class or function of one) at the port's counterpart, and
``sys.modules``' ``hdk_tpu`` entries too, so that an import inside a test
body finds the port.  ``hdk_tpu`` is then the port's package with
``HDK`` and ``init`` bound to the device; the reference's logger name
``hdk_tpu`` reads the port's, ``hdk_tpu_torch``.  A reference fixture of
module scope that makes a session is built anew for each device
(``per_device``).

The devices are ``cpu`` here and ``cuda`` (marked ``cuda``) on a card,
where no kernel's plain version runs while a session on the card
executes (``guard_plain_versions``).  The JAX package runs on the CPU
only: where a card is visible, or jax is not installed, ``hdk_tpu`` is
never imported and its names stand for the port's from the start (the
reference's files import there too).  What a twin holds against
``hdk_tpu`` itself it holds in its ``cpu`` cases (``run_on_reference``,
``assert_timer_steps_match``).
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib
import inspect
import logging
import os
import pkgutil
import sys
import threading
import types as pytypes

import numpy as np
import pytest
import torch

import hdk_tpu_torch
from hdk_tpu_torch.exec.executor import Executor
from hdk_tpu_torch.kernels import hist

TESTS = os.path.dirname(os.path.abspath(__file__))


def _port_modules() -> dict:
    """The port's modules by the reference's names (``hdk_tpu.X`` for
    ``hdk_tpu_torch.X``)."""
    out = {"hdk_tpu": hdk_tpu_torch}
    for m in pkgutil.walk_packages(hdk_tpu_torch.__path__, "hdk_tpu_torch."):
        out["hdk_tpu" + m.name[len("hdk_tpu_torch"):]] = \
            importlib.import_module(m.name)
    return out


_PORT = _port_modules()


def _reference():
    """``hdk_tpu``, where it may run: jax installed and no card visible
    (the JAX package runs on the CPU only).  Else None, and from here on
    the port answers to the reference's names.  Which tests a module has
    does not depend on this."""
    if not torch.cuda.is_available():
        try:
            import hdk_tpu
            return hdk_tpu
        except ImportError:  # no jax
            pass
    for name in [n for n in sys.modules
                 if n == "hdk_tpu" or n.startswith("hdk_tpu.")]:
        del sys.modules[name]
    sys.modules.update(_PORT)
    return None


REFERENCE = _reference()


def _functions(name: str) -> dict:
    """The module-level functions of ``tests/<name>.py`` by name, parsed
    from its text."""
    with open(os.path.join(TESTS, name + ".py")) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def reference_function(name: str, func: str):
    """A module-level function of ``tests/<name>.py`` built from the
    file's text, for a reference file that imports jax itself; the
    function sees numpy as ``np``.  A pytest fixture comes back as its
    plain function."""
    node = _functions(name)[func]
    node.decorator_list = []
    space = {"np": np}
    exec(compile(ast.Module([node], []), name + ".py", "exec"), space)
    return space[func]


def reference_test_names(name: str) -> set:
    """The names of the ``test_*`` functions of ``tests/<name>.py``."""
    return {n for n in _functions(name) if n.startswith("test_")}


# ---------------------------------------------------------------------------
# the port in the place of hdk_tpu
# ---------------------------------------------------------------------------

def _session_package(device: str) -> pytypes.ModuleType:
    """The port's package as ``hdk_tpu``, its sessions on ``device``."""
    pkg = pytypes.ModuleType("hdk_tpu", hdk_tpu_torch.__doc__)
    pkg.__dict__.update({k: v for k, v in vars(hdk_tpu_torch).items()
                         if not k.startswith("__")})
    pkg.HDK = functools.partial(hdk_tpu_torch.HDK, device=device)
    pkg.init = functools.partial(hdk_tpu_torch.init, device=device)
    return pkg


class _PortLogging:
    """``logging`` with the reference's logger names read as the port's."""

    def __getattr__(self, name):
        return getattr(logging, name)

    @staticmethod
    def getLogger(name=None):
        if name == "hdk_tpu" or (name or "").startswith("hdk_tpu."):
            name = "hdk_tpu_torch" + name[len("hdk_tpu"):]
        return logging.getLogger(name)


def _counterpart(value, pkg):
    """The port's object for a name the reference module holds, or
    ``value`` itself where it is not the reference's."""
    if value is logging:
        return _PortLogging()
    if isinstance(value, pytypes.ModuleType):
        name = value.__name__
        if name in ("hdk_tpu", "hdk_tpu_torch"):
            return pkg
        if name.startswith("hdk_tpu."):
            return _PORT[name]
        return value
    module = getattr(value, "__module__", None) or ""
    if module == "hdk_tpu" or module.startswith("hdk_tpu."):
        obj = _PORT[module]
        for part in value.__qualname__.split("."):
            obj = getattr(obj, part)
        return obj
    return value


def _patch(mp, ref, device: str) -> None:
    pkg = _session_package(device)
    for name, mod in _PORT.items():
        mp.setitem(sys.modules, name, pkg if name == "hdk_tpu" else mod)
    for name, value in list(vars(ref).items()):
        twin = _counterpart(value, pkg)
        if twin is not value:
            mp.setattr(ref, name, twin)


# a reference module to (its port_context's MonkeyPatch, the device)
_ACTIVE: dict = {}


@contextlib.contextmanager
def port_context(ref, device: str):
    """Run code of the reference module ``ref`` with the port, its
    sessions on ``device``, in the place of ``hdk_tpu``."""
    outer = _ACTIVE.get(ref)
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, ref, device)
        _ACTIVE[ref] = (mp, device)
        try:
            yield
        finally:
            if outer is None:
                del _ACTIVE[ref]
            else:
                _ACTIVE[ref] = outer


@contextlib.contextmanager
def reference_context():
    """Run code on ``hdk_tpu`` itself, with every ``port_context`` lifted
    meanwhile."""
    assert REFERENCE is not None, "hdk_tpu runs only on the CPU, with jax"
    active = list(_ACTIVE.items())
    for _, (mp, _) in active:
        mp.undo()
    try:
        yield REFERENCE
    finally:
        for ref, (mp, device) in active:
            _patch(mp, ref, device)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]

_executing = threading.local()


def guard_plain_versions(mp) -> None:
    """From here on a kernel's plain version refuses a CUDA tensor, and
    any call at all while a session on a CUDA device executes a query:
    a host copy of its gids or slots reaches it as a CPU tensor.  A CPU
    session beside the card's still runs them."""
    execute = Executor.execute

    def guarded(self, dag):
        outer = getattr(_executing, "cuda", False)
        _executing.cuda = outer or torch.device(self.device).type == "cuda"
        try:
            return execute(self, dag)
        finally:
            _executing.cuda = outer

    mp.setattr(Executor, "execute", guarded)
    for k in hist.KERNELS:
        name = k.__name__ + "_ref"
        plain = getattr(hist, name)

        def refuse(*args, _n=name, _plain=plain, **kwargs):
            if getattr(_executing, "cuda", False):
                raise AssertionError(f"{_n} ran while a CUDA session "
                                     f"executed")
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kwargs.values())):
                raise AssertionError(f"{_n} ran on a CUDA tensor")
            return _plain(*args, **kwargs)

        mp.setattr(hist, name, refuse)


def twin_module(ref=None, devices=DEVICES):
    """A twin module's autouse fixture ``device``: each test of the
    module runs once on each of ``devices``, inside
    ``port_context(ref, device)`` where ``ref`` is given, and on ``cuda``
    under ``guard_plain_versions``."""

    @pytest.fixture(scope="module", autouse=True, params=devices)
    def device(request):
        with contextlib.ExitStack() as stack:
            if request.param == "cuda":
                if not torch.cuda.is_available():
                    pytest.skip("needs a CUDA card")
                assert REFERENCE is None and "jax" not in sys.modules, \
                    "the JAX package runs beside the card"
                guard_plain_versions(
                    stack.enter_context(pytest.MonkeyPatch.context()))
            if ref is not None:
                stack.enter_context(port_context(ref, request.param))
            yield request.param

    return device


def per_device(fixture):
    """The reference's fixture ``fixture`` (of module scope, without
    arguments: a session), built anew for each device of the twin
    module."""
    func = fixture.__wrapped__
    assert not inspect.signature(func).parameters, func

    @pytest.fixture(scope="module", name=func.__name__)
    def bound(device):
        return func()

    return bound


@pytest.fixture(scope="module")
def rng(device):
    """The reference's shared generator (tests/conftest.py), anew for each
    device of a twin module."""
    return np.random.default_rng(42)


def assert_every_test_twinned(ref, namespace: dict, changed=()) -> None:
    """Each ``test_*`` of the reference module ``ref``'s file is collected
    in the twin module (``namespace``) as the reference's own function,
    but for those in ``changed`` (a name to the reason), which the twin
    replaces or leaves out, and which the reference must still have."""
    names = reference_test_names(ref.__name__)
    assert set(changed) <= names, sorted(set(changed) - names)
    for name in names - set(changed):
        assert namespace.get(name) is getattr(ref, name), name
    for name in changed:
        assert namespace.get(name) is not getattr(ref, name), name


# ---------------------------------------------------------------------------
# the same test on the reference
# ---------------------------------------------------------------------------

def _reference_fixture(ref, name: str, cache: dict, given: dict):
    if name in given:
        return given[name]
    if name in cache:
        return cache[name]
    fx = getattr(ref, name)
    func = fx.__wrapped__
    value = func(**{a: _reference_fixture(ref, a, cache, given)
                    for a in inspect.signature(func).parameters})
    if fx._fixture_function_marker.scope != "function":
        cache[name] = value
    return value


def run_on_reference(func, cache: dict, **given) -> dict:
    """Run the reference test ``func`` on ``hdk_tpu``: its arguments from
    ``given``, else the reference's own fixture bodies (those not of
    function scope kept in ``cache``).  Returns the arguments."""
    ref = sys.modules[func.__module__]
    with reference_context():
        kwargs = {a: _reference_fixture(ref, a, cache, given)
                  for a in inspect.signature(func).parameters}
        func(**kwargs)
    return kwargs


def run_on_port(func, cache: dict, **given) -> dict:
    """``run_on_reference`` on the port: the reference test ``func`` in
    the ``port_context`` it runs in, its fixtures built anew from their
    bodies (those not of function scope kept in ``cache``)."""
    ref = sys.modules[func.__module__]
    kwargs = {a: _reference_fixture(ref, a, cache, given)
              for a in inspect.signature(func).parameters}
    func(**kwargs)
    return kwargs


def on_reference_only(device: str) -> None:
    """Skip a comparison with ``hdk_tpu`` outside its ``cpu`` case."""
    if device != "cpu":
        pytest.skip("hdk_tpu runs only on the CPU: held against it in the "
                    "cpu case")
    if REFERENCE is None:
        pytest.skip("hdk_tpu runs only with jax")


@contextlib.contextmanager
def recorded(owner, name: str):
    """The return values of ``owner.name`` while the block runs."""
    out = []
    orig = getattr(owner, name)

    def spy(*args, **kwargs):
        value = orig(*args, **kwargs)
        out.append(value)
        return value

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(owner, name, spy)
        yield out


# ---------------------------------------------------------------------------
# the debug timer
# ---------------------------------------------------------------------------

def step_spans(package, run) -> tuple:
    """``run()`` twice with ``package``'s debug timer on: (the names of
    the step spans the first run opened, in order, read as the children
    of a ``query`` span around it; ``package.timer_report()`` after the
    second, alone)."""
    package.enable_debug_timer(True)
    try:
        with package.utils.timer.DebugTimer("query"):
            run()
        spans = [c["name"] for c in
                 package.timer_report().get("children", [])]
        run()
        report = package.timer_report()
    finally:
        package.enable_debug_timer(False)
    return spans, report


def step_kinds(names) -> list:
    """``step:Aggregate`` for ``step:Aggregate#7``."""
    return [n.split("#")[0] for n in names]


def timer_steps(tables: dict, run, device: str, package=hdk_tpu_torch):
    """``step_spans`` of ``run(session)`` in a session of ``package`` (on
    ``device`` for the port) holding ``tables`` (name to a numpy dict)."""
    s = (package.HDK(device=device) if package is hdk_tpu_torch
         else package.HDK())
    for name, data in tables.items():
        s.import_pydict(data, name=name)
    return step_spans(package, lambda: run(s))


def assert_timer_steps_match(tables: dict, run, device: str) -> None:
    """After ``run`` (see ``timer_steps``), the port's ``timer_report()``
    is its last step's span, with its ``ms``; in the ``cpu`` case the
    port opened ``hdk_tpu``'s step spans: the same kinds in the same
    order."""
    got, report = timer_steps(tables, run, device)
    assert report is not None and "ms" in report, report
    assert got and step_kinds([report["name"]]) == step_kinds(got[-1:]), \
        (report, got)
    if device == "cpu" and REFERENCE is not None:
        with reference_context():
            want, _ = timer_steps(tables, run, device, REFERENCE)
        assert step_kinds(got) == step_kinds(want), (got, want)
