"""The port's ``Configuration`` against the reference's: every field of
``netsdb_tpu.config.Configuration`` is accepted at the reference's
default, and every knob of a later ROADMAP.md item raises
``NotImplementedError`` naming its item when set away from it. The
one-daemon serving knobs (the scheduler's, the sessions', the decode
runtime's) are ported, with the reference's checks."""

import dataclasses

import pytest

from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu_torch.config import _LATER, Configuration

REF_FIELDS = dataclasses.fields(JConfiguration)


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


def test_the_port_has_every_field_of_the_reference():
    port = {f.name for f in dataclasses.fields(Configuration)}
    assert {f.name for f in REF_FIELDS} == port
    assert len(port) == 65


@pytest.mark.parametrize("field", REF_FIELDS, ids=lambda f: f.name)
def test_each_reference_field_at_its_default_builds(field, tmp_path):
    value = _default(field)
    if field.name == "root_dir":
        value = str(tmp_path / "port")
    cfg = Configuration(**{field.name: value})
    assert getattr(cfg, field.name) == value


def test_all_reference_defaults_at_once(tmp_path):
    values = {f.name: _default(f) for f in REF_FIELDS}
    values["root_dir"] = str(tmp_path / "port")
    cfg = Configuration(**values)
    for name, value in values.items():
        assert getattr(cfg, name) == value
    # the defaults the port reads are the reference's
    ref = JConfiguration(root_dir=str(tmp_path / "ref"))
    for name in ("default_block_shape", "page_size_bytes",
                 "shared_mem_bytes", "page_pool_bytes",
                 "stream_prefetch_pages", "stage_depth", "shape_bucketing",
                 "bucket_density", "plan_fusion", "fusion_min_region",
                 "fusion_cost_source", "fusion_mapper",
                 "fusion_stage_budget_bytes", "device_cache_bytes",
                 "device_cache_partial", "device_cache_pin_bytes",
                 "device_cache_dirty_log", "obs_explain"):
        assert getattr(Configuration(), name) == getattr(ref, name), name


def _away(default):
    """A value other than ``default`` of a plausible type."""
    if isinstance(default, bool):
        return not default
    if default is None:
        return 2
    if isinstance(default, tuple):
        return ("x", "y")
    if isinstance(default, (int, float)):
        return default * 3 + 1
    return default + "x"


#: knobs of the serving slices (one daemon, then its shard pool): raised
#: until they were ported, accepted away from their defaults since
SERVING_PORTED = ("decode_batch_max", "model_dedup", "sched_affinity",
                  "sched_affinity_wait_s", "sched_aging_every",
                  "sched_coalesce", "sched_coalesce_done_max",
                  "sched_coalesce_done_ttl_s", "sched_lane_quota",
                  "sched_lanes", "session_state_bytes", "session_ttl_s",
                  "shard_handoff_bytes")


#: knobs of the in-process mesh slice (ROADMAP.md A4 part 2): raised until
#: they were ported, accepted away from their defaults since (the
#: reference checks ``summa_grid`` where it is read, not here)
MESH_PORTED = ("distributed_matmul", "mesh_axis_names", "mesh_shape",
               "summa_grid", "summa_participants")

#: knobs of the observability slice (ROADMAP.md A8, observability part) and
#: of the scheduler's feedback that reads it: raised until they were
#: ported, accepted away from their defaults since
OBS_PORTED = ("obs_device_profile_dir", "obs_enabled", "obs_hist_samples",
              "obs_history_interval_s", "obs_history_len",
              "obs_slow_query_s", "obs_slowlog_entries", "obs_trace_ring",
              "obs_trace_sample", "sched_feedback", "sched_feedback_every",
              "sched_slo_shed")

#: knobs of the replication slice (ROADMAP.md A7 part 2, followers and
#: HA): raised until they were ported, accepted away from their defaults
#: since
HA_PORTED = ("ha_election_timeout_s", "ha_mutlog")


@pytest.mark.parametrize("name", sorted(set(_LATER) | set(SERVING_PORTED)
                                        | set(MESH_PORTED) | set(OBS_PORTED)
                                        | set(HA_PORTED)))
def test_each_later_knob_raises_naming_its_item(name, tmp_path):
    if name in SERVING_PORTED or name in MESH_PORTED or name in OBS_PORTED \
            or name in HA_PORTED:
        assert name not in _LATER
        default = _default(next(f for f in REF_FIELDS if f.name == name))
        value = {"a": 2.0} if name == "sched_lanes" else _away(default)
        cfg = Configuration(root_dir=str(tmp_path), **{name: value})
        assert getattr(cfg, name) == value
        return
    default, item = _LATER[name]
    with pytest.raises(NotImplementedError,
                       match=f"{name}.*ROADMAP.md {item}"):
        Configuration(root_dir=str(tmp_path), **{name: _away(default)})


@pytest.mark.parametrize("knob,value", [
    ("session_ttl_s", 0.0), ("session_state_bytes", -1),
    ("decode_batch_max", 0)])
def test_serving_knobs_keep_the_reference_checks(knob, value, tmp_path):
    from netsdb_tpu.config import Configuration as Ref

    with pytest.raises(ValueError, match=knob):
        Ref(root_dir=str(tmp_path / "ref"), **{knob: value})
    with pytest.raises(ValueError, match=knob):
        Configuration(root_dir=str(tmp_path), **{knob: value})


def test_later_knobs_name_their_roadmap_items():
    items = {name: item for name, (_, item) in _LATER.items()}
    for name in MESH_PORTED:  # ported with the in-process mesh
        assert name not in items
    assert not any(item.startswith("A4") for item in items.values())
    for name in items:
        if name.startswith(("ha_", "rebalance")):
            assert items[name] == "A7 part 2", name
    # the observability slice ported obs/ and the scheduler's feedback
    assert not any(n.startswith(("sched_", "obs_")) for n in items)
    assert not any(n.startswith("session_") or n in SERVING_PORTED
                   or n in OBS_PORTED for n in items)
    assert "shard_handoff_bytes" not in items  # the shard pool's buffer
    assert not any(n in items for n in HA_PORTED)  # followers and HA
    assert items["device_cache_pin_auto"] == "A7 part 2"
    assert items["lock_witness"] == "A8"
    assert "obs_explain" not in items  # read by obs/operators.py


def test_donate_fold_buffers_and_compile_cache(tmp_path):
    assert Configuration(donate_fold_buffers=False).donate_fold_buffers \
        is False
    with pytest.raises(ValueError, match="donate"):
        Configuration(donate_fold_buffers=True)
    for ok in (None, "", "auto"):
        assert Configuration(compilation_cache_dir=ok) is not None
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8"):
        Configuration(compilation_cache_dir=str(tmp_path / "cc"))


def test_knobs_read_by_no_in_process_path_are_taken(tmp_path):
    cfg = Configuration(compute_dtype="float32", accum_dtype="bfloat16",
                        storage_dtype="bfloat16", num_threads=16,
                        log_level="DEBUG", enable_compression=False)
    assert (cfg.compute_dtype, cfg.num_threads, cfg.log_level) == \
        ("float32", 16, "DEBUG")
