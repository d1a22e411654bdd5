"""The root conftest's scheduling: the heaviest test files first, with
nothing lost and xdist's own reorder off."""

import importlib.util
import pathlib
import types

TESTS = pathlib.Path(__file__).resolve().parent

_spec = importlib.util.spec_from_file_location("root_conftest", TESTS.parent / "conftest.py")
order = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(order)


def fake_items(names, per_file=3):
    """Items of `names` in collection order, `per_file` tests a file."""
    return [types.SimpleNamespace(path=TESTS / name, nodeid=f"tests/{name}::test_{i}")
            for name in names for i in range(per_file)]


def test_heavy_files_exist():
    assert len(set(order.HEAVY_FILES_FIRST)) == len(order.HEAVY_FILES_FIRST)
    for name in order.HEAVY_FILES_FIRST:
        assert (TESTS / name).is_file(), name


def test_hook_puts_heavy_files_first():
    names = sorted(p.name for p in TESTS.glob("test_*.py"))
    items = fake_items(names)
    before = list(items)
    order.pytest_collection_modifyitems(types.SimpleNamespace(), items)

    assert sorted(map(id, items)) == sorted(map(id, before))
    heavy = order.HEAVY_FILES_FIRST
    assert [it.path.name for it in items[:3 * len(heavy):3]] == list(heavy)
    # every file keeps its own item order; the rest keep collection order
    assert [it for it in items if it.path.name not in heavy] == \
        [it for it in before if it.path.name not in heavy]
    for name in heavy:
        assert [it for it in items if it.path.name == name] == [it for it in before if it.path.name == name]


def test_suite_runs_heavy_files_first(request):
    """The hook ran on this session's items: the tuple's files lead, in order."""
    seen = []
    for item in request.session.items:
        name = item.path.name
        if not seen or seen[-1] != name:
            seen.append(name)
    collected = [name for name in order.HEAVY_FILES_FIRST if name in seen]
    assert seen[:len(collected)] == collected


def test_xdist_reorder_is_off(request):
    if hasattr(request.config.option, "loadscopereorder"):
        assert request.config.option.loadscopereorder is False
