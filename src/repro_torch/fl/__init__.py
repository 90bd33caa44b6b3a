from .engine import (
    ClassificationTask,
    DeviceFLClients,
    FLClients,
    FLRun,
    MLPClassifier,
    TaskSetup,
    params_from_numpy,
    run_experiment,
    run_matrix,
    sampling_for,
)
