"""The port's copied configs equal the JAX package's.

``repro_torch.configs`` is a framework-free copy of ``repro.configs`` with
its imports rewritten. For every architecture the registry knows: the
fields (``dataclasses.asdict``), the reduced config, the analytic parameter
counts and the shapes the architecture runs.
"""
import dataclasses

import pytest

import repro.configs as R
import repro_torch.configs as P
from repro.configs.shapes import skipped_shapes_for as r_skipped
from repro_torch.configs.shapes import skipped_shapes_for as p_skipped


def test_registry_names_every_arch():
    assert P.list_archs() == R.list_archs()
    assert len(P.list_archs()) == 10
    assert {k: v.replace("repro_torch.", "repro.", 1)
            for k, v in P.ARCHS.items()} == R.ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        P.get_config("no-such-arch")


@pytest.mark.parametrize("arch", R.list_archs())
def test_config_equals_reference(arch):
    r, p = R.get_config(arch), P.get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for width in (64, 128):
        assert (dataclasses.asdict(p.reduced(width))
                == dataclasses.asdict(r.reduced(width)))
    for cfg_r, cfg_p in ((r, p), (r.reduced(), p.reduced())):
        assert cfg_p.param_count() == cfg_r.param_count()
        assert cfg_p.active_param_count() == cfg_r.active_param_count()
        assert cfg_p.padded_vocab == cfg_r.padded_vocab
        assert cfg_p.n_layers == cfg_r.n_layers
    assert ([dataclasses.asdict(s) for s in P.shapes_for(p)]
            == [dataclasses.asdict(s) for s in R.shapes_for(r)])
    assert p_skipped(p) == r_skipped(r)


def test_shape_table_equals_reference():
    assert ({k: dataclasses.asdict(v) for k, v in P.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in R.SHAPES.items()})
