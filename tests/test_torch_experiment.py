"""The port's spec layer equals the reference's: every preset, every
field and its doc, spec JSON round trips across packages, overrides,
validation, and the spec → GCNConfig builder."""
import dataclasses

import pytest

from repro.core import experiment as ref_exp
from repro.core.gcn import GCNConfig as RefGCNConfig
from repro_torch.core import experiment as exp
from repro_torch.core.gcn import GCNConfig

PRESETS = ref_exp.list_presets()


def test_preset_registries_list_the_same_names():
    assert exp.list_presets() == PRESETS


@pytest.mark.parametrize("name", PRESETS)
def test_preset_specs_equal_and_round_trip(name):
    """Each preset builds the same spec in both packages, and a spec
    JSON the reference writes round-trips through the port unchanged."""
    want = ref_exp.preset(name)
    assert exp.preset(name).to_dict() == want.to_dict()
    ported = exp.ExperimentSpec.from_json(want.to_json())
    assert ported.to_json() == want.to_json()


def test_every_spec_field_and_doc_is_copied():
    for key, ref_cls in ref_exp._SECTIONS.items():
        cls = exp._SECTIONS[key]
        ref_fields = [(f.name, f.default, f.metadata.get("doc"))
                      for f in dataclasses.fields(ref_cls)]
        fields = [(f.name, f.default, f.metadata.get("doc"))
                  for f in dataclasses.fields(cls)]
        assert fields == ref_fields, key


def test_gcn_config_fields_and_defaults_match():
    def sig(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert sig(GCNConfig) == sig(RefGCNConfig)
    cfg = GCNConfig(in_dim=5, hidden_dim=7, out_dim=3, num_layers=4)
    assert cfg.dims == RefGCNConfig(in_dim=5, hidden_dim=7, out_dim=3,
                                    num_layers=4).dims


def test_overrides_and_set_items_match():
    items = ["run.epochs=2", "batch.k_slots=auto", "serve.buckets=[1,4]",
             "model.precision=\"bf16\"", "data.cache_dir=null"]
    a = exp.apply_overrides(exp.preset("ppi_tiny"),
                            exp.parse_set_items(items))
    b = ref_exp.apply_overrides(ref_exp.preset("ppi_tiny"),
                                ref_exp.parse_set_items(items))
    assert a.to_dict() == b.to_dict()
    with pytest.raises(KeyError):
        exp.apply_overrides(exp.preset("ppi_tiny"), {"run.nope": 1})
    with pytest.raises(ValueError):
        exp.parse_set_items(["no-equals-sign"])


@pytest.mark.parametrize("path,value", [
    ("batch.norm", "eq7"), ("batch.sampler", "bogus"),
    ("serve.buckets", [4, 2]), ("serve.imbalance_threshold", 1.0),
    ("model.precision", "fp8"), ("data.scale", 0.5)])
def test_validate_rejects_what_the_reference_rejects(path, value):
    name = "ppi_real" if path == "data.scale" else "ppi_tiny"
    for mod in (exp, ref_exp):
        spec = mod.preset(name)
        mod.set_override(spec, path, value)
        with pytest.raises(ValueError, match=path.replace(".", r"\.")):
            mod.validate(spec)


def test_build_gcn_config_matches():
    spec = exp.preset("ppi_sota")
    graph = exp.build_graph(exp.preset("ppi_tiny"))
    got = exp.build_gcn_config(spec, graph)
    want = ref_exp.build_gcn_config(ref_exp.preset("ppi_sota"), graph)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_layers, got.hidden_dim) == (5, 2048)
