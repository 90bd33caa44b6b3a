from .engine import (
    ClassificationTask,
    DeviceFLClients,
    DeviceTaskClients,
    FLClients,
    FLRun,
    LMTask,
    MLPClassifier,
    TaskSetup,
    params_from_numpy,
    run_experiment,
    run_matrix,
    sampling_for,
)
