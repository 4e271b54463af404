"""The port's plan layer, engine half (``repro_torch.engine``: ``Pipeline``,
optimizer, analyzer, retrieval operators), against the reference
(``repro.engine``) on the CPU, both on ``MockProvider``.

The reference's own cases run on both packages side by side
(``torch_port_cases``): each keeps its assertions and margins, run on the
port, and every ``collect()`` table, ``explain()`` text (measured walls
masked), ``check()`` diagnostic and optimized plan of the port must equal
the reference's.  Ported here: the plans of ``tests/test_{optimizer,
retrieval_ops,analysis,spec_pipelining,system}.py`` (all but the
mesh-sharded scan, a later slice), and the cases of ``tests/test_{
scheduler,copack,speculative,latency}.py`` that build a ``Pipeline``.

The one intended difference, the analyzer's repair of ROADMAP C.4, has a
fixed case of its own, and the port's copy of the random-plan property
runs under fixed draws.
"""

from hypothesis import given, settings
from hypothesis import strategies as st

import repro.engine as RE
import repro_torch.engine as TE
from torch_port_cases import load, port_cases

SMALL = settings(max_examples=40, deadline=None, derandomize=True,
                 database=None)

# the cases the core half's port (tests/test_torch_{core,scheduler}.py)
# left for this one because they build a Pipeline; the scheduler's run
# first, before the speculative cases' threads
globals().update(port_cases("test_scheduler", [
    "test_scheduled_results_identical_to_serial",
    "test_parallel_sibling_nodes_sharing_keys_match_serial_counts",
    "test_independent_nodes_overlap_wall_clock",
    "test_dispatch_groups_respect_def_use_edges",
    "test_mixed_speculative_and_map_load_respects_gates_no_starvation"],
    # the sibling case's second node borrows the first one's in-flight
    # keys or reads them from the cache, as the threads fall: its report
    # says coalesced or cache_hits, in both packages (its own assertions
    # hold the rows and the request count to the serial run's)
    timed=["test_parallel_sibling_nodes_sharing_keys_match_serial_counts",
           "test_mixed_speculative_and_map_load_respects_gates_no_starvation"],
    # its own assertions time the port's scheduler against the serial
    # run; a second, reference run in the same worker adds only load
    port_only=["test_independent_nodes_overlap_wall_clock"]))

globals().update(port_cases("test_optimizer", [
    "test_golden_pushdown_limit_and_order_by",
    "test_golden_fusion_filter_complete_json",
    "test_golden_filter_chain_reorder",
    "test_golden_explain_shows_both_plans_with_estimates",
    "test_opaque_relational_filter_not_pushed_past_map",
    "test_declared_filter_on_output_column_not_pushed",
    "test_limit_not_pushed_past_llm_filter",
    "test_no_fusion_across_models_or_columns",
    "test_no_fusion_when_inline_model_limits_differ",
    "test_fusion_rejected_when_filter_is_highly_selective",
    "test_filter_reorder_keeps_already_optimal_chain",
    "test_callable_order_by_key_not_pushed",
    "test_equivalence_pushdown",
    "test_equivalence_fusion_identical_rows_fewer_requests",
    "test_equivalence_filter_reorder",
    "test_escape_hatch_runs_plan_as_written",
    "test_llm_multi_decodes_every_kind",
    "test_llm_multi_rejects_unfusable_kind",
    "test_llm_multi_records_filter_selectivity",
    "test_parse_rows_empty_and_malformed",
    "test_parse_rows_out_of_range_and_whitespace",
    "test_parse_rows_last_assignment_wins",
    "test_parse_permutation_garbage_and_duplicates",
    "test_plan_batches_empty_input",
    "test_plan_batches_max_batch_one",
    "test_plan_batches_oversized_singleton_isolated",
    "test_execute_serial_overflow_shrink_path",
    "test_execute_serial_single_tuple_overflow_is_null",
    "test_run_adaptive_alias_removed"]))

globals().update(port_cases("test_retrieval_ops", [
    "test_fusion_all_nan_column_contributes_nothing",
    "test_fusion_single_retriever_input",
    "test_rrf_tied_scores_share_rank",
    "test_rrf_independent_of_tie_reporting_order",
    "test_combmnz_zero_non_nan_rows_are_exact_zero",
    "test_fusion_input_validation",
    "test_vector_topk_matches_imperative",
    "test_bm25_topk_matches_imperative",
    "test_hybrid_topk_plus_rerank_bit_identical_to_imperative",
    "test_hybrid_fusion_methods_dispatch",
    "test_retrieval_empty_query_table_keeps_schema",
    "test_doc_column_collision_gets_suffix",
    "test_corpus_filter_pushdown_preserves_results",
    "test_corpus_filter_pushdown_vector_topk_preserves_results",
    "test_query_side_filter_pushes_below_retrieval",
    "test_filter_on_retrieval_outputs_stays_above",
    "test_k_pushdown_sets_candidate_depth",
    "test_shared_corpus_embeds_once_and_is_noted",
    "test_explain_reports_retrieval_cost",
    "test_explain_embed_estimate_drops_after_index_is_built",
    "test_index_store_reuse_across_sessions",
    "test_index_store_corruption_recovery",
    "test_index_store_prunes_reversioned_models",
    "test_index_store_capacity_bound",
    "test_index_roundtrip_is_bit_exact",
    "test_embedding_dispatch_is_batch_planned",
    "test_embedding_respects_headroom",
    "test_embedding_scheduler_counts_match_serial_with_batches",
    "test_embedding_nodes_copack_fewer_requests_same_rows",
    "test_retrieval_corpus_query_copack_deterministic_stress",
    "test_llm_rerank_by_group_matches_per_group_rerank",
    "test_corpus_fingerprint_is_order_sensitive",
    "test_corpus_fingerprint_is_unambiguous",
    "test_select_pushdown_keeps_grouped_rerank_key"],
    timed=["test_retrieval_corpus_query_copack_deterministic_stress"]))

globals().update(port_cases("test_analysis", [
    "test_flk001_unresolved_model_ref",
    "test_registered_model_ref_resolves",
    "test_flk002_unresolved_prompt_ref",
    "test_flk003_placeholder_without_column",
    "test_flk003_placeholder_bound_and_json_braces_exempt",
    "test_flk003_catalog_prompt_placeholders_checked",
    "test_flk004_missing_input_column",
    "test_flk004_column_created_upstream_is_visible",
    "test_flk005_bad_k",
    "test_flk005_bad_fusion",
    "test_flk005_model_spec_type",
    "test_flk005_nprobe_above_nlist_is_warning_only",
    "test_flk006_retrieval_column_collision_matches_runtime",
    "test_retrieval_doc_rename_inferred",
    "test_inferred_schema_matches_execution_across_ops",
    "test_explain_renders_inferred_schema",
    "test_invalid_plan_rejected_with_zero_provider_requests",
    "test_verify_warn_reports_and_proceeds",
    "test_verify_off_skips_analysis",
    "test_bad_verify_value",
    "test_strict_discharges_pushdown",
    "test_strict_discharges_fusion",
    "test_strict_discharges_filter_reorder",
    "test_strict_discharges_prune_corpus",
    "test_strict_discharges_k_pushdown",
    "test_strict_discharges_forced_ivf",
    "test_strict_discharges_ann_auto_without_execution",
    "test_strict_discharges_shared_corpus_embed",
    "test_strict_discharges_speculative_chain",
    "test_flk010_tampered_commute_is_caught",
    "test_flk010_dropped_filter_is_caught",
    "test_strict_collect_catches_tampered_plan"]))

globals().update(port_cases("test_spec_pipelining", [
    "test_spec_map_bit_identical_and_verifies",
    "test_spec_map_absorbs_spec_chain_members",
    "test_spec_map_writes_discarded_rows_to_cache",
    "test_spec_map_rejected_by_tight_cap_runs_serially",
    "test_map_cap_objective_flip",
    "test_partial_chain_speculates_cheap_prefix_only",
    "test_full_speculation_still_chosen_when_tail_is_cheap",
    "test_spec_rerank_bit_identical_and_verifies",
    "test_spec_rerank_requires_prediction_cache",
    "test_spec_rerank_rejects_score_reading_rerank",
    "test_spec_rerank_warmup_prefills_window_cache",
    "test_property_spec_map_modes_identical",
    "test_property_partial_chain_modes_identical",
    "test_property_spec_rerank_modes_identical",
    "test_speculated_chain_records_mask_densities",
    "test_speculated_map_records_filter_density",
    "test_join_cancelled_tasks_never_run",
    "test_join_cancelled_work_never_reaches_provider",
    "test_join_counters_on_scheduler_stats",
    "test_join_mandatory_tasks_ignore_cancellation",
    "test_join_bounds_concurrent_runners",
    "test_join_bounds_inflight_rows",
    "test_join_error_fails_fast_and_cancels_rest",
    "test_scheduler_stats_counters_flow_from_pipeline"],
    timed=["test_spec_map_bit_identical_and_verifies",
           "test_spec_map_absorbs_spec_chain_members",
           "test_spec_rerank_bit_identical_and_verifies",
           # the question's embed request joins the corpus's within the
           # packing linger or not: 3 or 4 provider calls, in the reference
           # as in the port (2 in 150 reference runs under load)
           "test_spec_rerank_warmup_prefills_window_cache",
           "test_property_spec_map_modes_identical",
           "test_property_partial_chain_modes_identical",
           "test_property_spec_rerank_modes_identical"]))

globals().update(port_cases("test_system", [
    "test_query2_pipeline", "test_query2_dedup_batching_visible",
    "test_query3_hybrid_search", "test_ask_demo",
    "test_resource_versioning"]))

globals().update(port_cases("test_copack", [
    "test_copack_identity_mirrors_map_core",
    "test_copack_pipeline_fewer_requests_same_rows",
    "test_copack_deterministic_under_concurrency",
    "test_copack_escape_hatch_matches_serial_counts",
    "test_explain_reports_packed_request_estimate",
    "test_copack_same_name_different_caps_do_not_merge",
    "test_copack_identity_covers_fused_nodes",
    "test_copack_concurrent_distinct_prefixes_do_not_merge"]))

globals().update(port_cases("test_speculative", [
    "test_speculative_chain_equals_serial",
    "test_speculative_chain_equals_serial_fixed_cases",
    "test_speculative_chain_without_scheduler_matches_serial",
    "test_optimize_false_ignores_speculation",
    "test_auto_speculates_when_waves_win",
    "test_auto_rejects_when_waste_exceeds_cap",
    "test_auto_uses_calibrated_wall_when_available",
    "test_explain_reports_speculation_section",
    "test_retry_rate_inflates_calibrated_request_estimate"]))

globals().update(port_cases("test_latency", [
    "test_collect_objective_override_restores_context",
    "test_explain_reports_objective_frontiers",
    "test_frontiers_price_pack_wait_when_calibrated",
    "test_objective_validation",
    "test_parked_tail_deadline_respects_calibrated_window"]))


# ---------------------------------------------------------------------------
# ROADMAP C.4: the one intended difference of the port's analyzer
# ---------------------------------------------------------------------------
C4_STEPS = ["filter_join", "limit3", "filter_join", "order_year"]


def _c4_verdict(port):
    """The reference's drawn plan of C.4 through one package's analyzer:
    (optimized operators, rewrites, obligations that failed)."""
    mod = load("test_analysis", port)
    E = TE if port else RE
    ctx = mod._ctx()
    table = E.Table({
        "id": list(range(10)),
        "text": [f"paper {i} about {'join' if i % 2 else 'index'}"
                 for i in range(10)],
        "year": [2000 + i for i in range(10)],
    })
    pipe = E.Pipeline(ctx, table, "t")
    for i, s in enumerate(C4_STEPS):
        pipe = mod._apply(pipe, s, i)
    opt = pipe._plan(False)
    return ([n.op for n in opt.nodes], list(opt.rewrites),
            E.verify_rewrites(ctx, table, pipe.nodes, opt))


def test_c4_duplicate_semantic_nodes_verify_clean_on_the_port():
    ref_ops, ref_rewrites, ref_failed = _c4_verdict(port=False)
    ops, rewrites, failed = _c4_verdict(port=True)
    # one true rewrite: the order_by moves below the SECOND llm_filter
    assert ops == ref_ops == ["scan", "llm_filter", "limit", "order_by",
                              "llm_filter"]
    assert rewrites == ref_rewrites == [
        "pushdown(order_by before llm_filter)"]
    # the reference finds the FIRST identical llm_filter by its key and
    # reports a false FLK010; the port finds the node by identity
    assert [d.code for d in ref_failed] == ["FLK010"]
    assert "runs before llm_filter but it does not" in ref_failed[0].message
    assert failed == []


@SMALL
@given(steps=st.lists(st.sampled_from(load("test_analysis", True)._STEPS),
                      min_size=1, max_size=6),
       speculate=st.sampled_from([False, "always"]))
def test_property_random_plans_analyze_and_verify(steps, speculate):
    """The port's copy of the reference's random-plan property, under
    fixed draws."""
    load("test_analysis", True)._check_random_plan(steps, speculate)


def test_property_random_plans_include_c4_plan():
    """The C.4 plan itself, through the property's own check on the
    port."""
    load("test_analysis", True)._check_random_plan(C4_STEPS, False)
