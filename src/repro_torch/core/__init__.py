"""Core library: the paper's contribution (queueing analysis + Generalized AsyncSGD)."""
from .jackson import (
    JacksonNetwork,
    MixedServingResult,
    batched_expected_delays,
    mixed_serving_analysis,
    serving_slo,
    buzen_add_node,
    buzen_log_add_node,
    buzen_log_normalizing_constants,
    buzen_log_remove_node,
    buzen_normalizing_constants,
    buzen_remove_node,
    buzen_replace_node,
    gamma_ratio,
    three_cluster_delay_bounds,
    two_cluster_delay_bounds,
)
from .classes import ClassSpec, build_class_spec
from .engine_scan import (
    GuardConfig,
    blocked_inputs,
    blocked_inputs_batch,
    jit_runner,
    make_runner,
    step_scales,
    stream_arrays,
)
from .engine_ckpt import (
    run_checkpointed,
    run_checkpointed_host,
    run_checkpointed_host_blocked,
)
from .scenario import (
    SCENARIOS,
    ModulationConfig,
    ScenarioConfig,
    ServiceLaw,
    get_scenario,
    list_scenarios,
    register_scenario,
)
from .queue_sim import (
    KIND_COMPLETE,
    KIND_CRASH,
    KIND_FLIP,
    KIND_SERVE,
    KIND_STAGE,
    KIND_TIMEOUT,
    ClosedNetworkSim,
    EventBlocks,
    EventStream,
    FaultConfig,
    SimConfig,
    SimResult,
    export_blocks,
    export_stream,
    segment_blocks,
    select_block_size,
    simulate,
    simulate_batch,
)
from .sampling import (
    SamplingResult,
    TradeoffResult,
    bound_for_p,
    bound_for_p_batch,
    bound_value_and_grad,
    optimize_general,
    optimize_physical_time,
    optimize_tradeoff,
    optimize_two_cluster,
    two_cluster_p_vector,
)
from .theory import (
    BoundConstants,
    asyncsgd_bound,
    asyncsgd_eta_max,
    eta_max,
    fedbuff_bound,
    fedbuff_eta_max,
    generalized_bound,
    optimal_eta,
)
from .async_sgd import (
    ServerConfig,
    TraceRecord,
    run_favano,
    run_fedavg,
    run_fedbuff,
    run_generalized_async_sgd,
)
