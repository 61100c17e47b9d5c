"""The port's copy of the paper's workload configuration
(``repro_torch.configs.vss_paper``: Table 1's datasets and the §3–§5
store constants) equals the reference's field by field, and imports with
jax and the reference blocked."""
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.configs import vss_paper as J
from repro_torch.configs import vss_paper as T

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("i", range(len(J.DATASETS)),
                         ids=[d.name for d in J.DATASETS])
def test_dataset_equals_reference_field_by_field(i):
    assert len(T.DATASETS) == len(J.DATASETS)
    assert dataclasses.asdict(T.DATASETS[i]) == dataclasses.asdict(
        J.DATASETS[i])


def test_store_defaults_equal_reference_field_by_field():
    assert dataclasses.asdict(T.CONFIG) == dataclasses.asdict(J.CONFIG)
    assert dataclasses.asdict(T.StoreDefaults()) == dataclasses.asdict(
        J.StoreDefaults())
    assert T.CONFIG == T.StoreDefaults()


def test_classes_have_the_references_fields_and_are_frozen():
    for t, j in ((T.VideoDataset, J.VideoDataset),
                 (T.StoreDefaults, J.StoreDefaults)):
        assert [(f.name, f.type, f.default) for f in dataclasses.fields(t)] \
            == [(f.name, f.type, f.default) for f in dataclasses.fields(j)]
        assert t.__dataclass_params__.frozen
    with pytest.raises(dataclasses.FrozenInstanceError):
        T.CONFIG.gamma = 3.0


def test_imports_with_jax_and_reference_blocked():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(REPO / "src")!r})
        from repro_torch.configs.vss_paper import CONFIG, DATASETS
        print(len(DATASETS), CONFIG.tau_db)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(len(J.DATASETS)), str(J.CONFIG.tau_db)]
