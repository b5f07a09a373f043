"""The port's public names against the JAX package's ``__all__``: every
name resolves in the port, or stands in ``STILL_TO_PORT`` under the
ROADMAP §A item that queues it, and that list equals the one in
ROADMAP.md, so a slice that ports a name strikes it in both places."""

import pathlib
import re

import symbolicregression_jl_tpu as jsr
import symbolicregression_jl_tpu_torch as sr

# ROADMAP §A item -> the reference's public names that item brings
STILL_TO_PORT = {
    9: ("FitnessMemoBank", "clear_memo_banks", "tree_hash_host"),
    10: ("SymbolicRegressor", "do_precompilation", "enable_compilation_cache",
         "save_search_state", "load_search_state", "FaultInjected",
         "FaultPlan", "SupervisedResult", "supervised_search",
         "set_fault_plan", "clear_fault_plan"),
    11: ("EventLog", "MetricsRegistry", "SpanRecorder", "analyze_run",
         "compare_runs", "device_peaks", "hypervolume_2d", "open_event_log",
         "profile_report", "validate_events_file", "AlertRule",
         "DEFAULT_ALERT_RULES", "FleetScanner", "evaluate_alerts",
         "register_run", "render_openmetrics", "serve_metrics",
         "validate_exposition", "write_textfile"),
    12: ("current_device_kind", "default_cache_path", "load_tune_cache",
         "lookup_kernel_config", "model_ranked_sweep", "save_tune_cache",
         "sweep_to_cache", "tuned_min_work", "update_tune_cache",
         "validate_tune_cache"),
}
ROADMAP = pathlib.Path(__file__).resolve().parents[1] / "ROADMAP.md"


def _still_to_port():
    return {n for names in STILL_TO_PORT.values() for n in names}


def test_every_reference_name_resolves_or_is_queued():
    missing = [n for n in jsr.__all__ if not hasattr(sr, n)]
    assert set(missing) == _still_to_port(), (
        sorted(set(missing) - _still_to_port()),
        sorted(_still_to_port() - set(missing)))
    assert set(sr.__all__) >= set(jsr.__all__) - _still_to_port()
    assert all(hasattr(sr, n) for n in sr.__all__)


def test_still_to_port_equals_the_roadmap_list():
    """ROADMAP.md holds the list between its ``still-to-port`` markers, one
    line per §A item: ``- item N: `name`, `name`, ...``."""
    text = ROADMAP.read_text()
    block = re.search(r"<!-- still-to-port -->(.*?)<!-- /still-to-port -->",
                      text, re.S)
    assert block, "ROADMAP.md has no still-to-port list"
    listed = {}
    for line in block.group(1).strip().splitlines():
        m = re.match(r"- item (\d+): (.*)$", line.strip())
        assert m, line
        listed[int(m.group(1))] = tuple(re.findall(r"`([^`]+)`", m.group(2)))
    assert {k: set(v) for k, v in listed.items()} == {
        k: set(v) for k, v in STILL_TO_PORT.items()}


def test_reference_aliases():
    """``EquationSearch`` is ``equation_search``; ``s_r_cycle`` is the
    island-batched cycle loop on one island, bit for bit."""
    import torch

    from symbolicregression_jl_tpu_torch.models import evolve as tevolve
    from symbolicregression_jl_tpu_torch.models.cycle_graph import _leaves
    from torch_port_helpers import island_keys, make_generator, random_trees

    assert sr.EquationSearch is sr.equation_search
    X = torch.randn(2, 30, generator=torch.Generator().manual_seed(0))
    y = X[0] * X[1]
    o = sr.make_options(binary_operators=["+", "*"], npop=16, npopulations=1,
                        tournament_selection_n=6, maxsize=8, verbosity=0,
                        should_optimize_constants=False)
    st = tevolve.init_island_state(island_keys(0, 1), o, 2, X, y, None, 1.0)
    one = sr.s_r_cycle(tevolve._map_tensors(lambda x: x[0], st), 8, X, y,
                       None, 1.0, o, ncycles=3)
    ref = tevolve.s_r_cycle_islands(st, 8, X, y, None, 1.0, o, ncycles=3)
    got = _leaves(tevolve._map_tensors(lambda x: x.unsqueeze(0), one))
    assert len(got) == len(_leaves(ref))
    assert all(torch.equal(t, u) for t, u in zip(got, _leaves(ref)))
