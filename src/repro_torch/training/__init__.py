"""The training path: AdamW and its schedules
(``optimizer``), the train step with gradient accumulation
(``train_step``), atomic checkpoints (``checkpoint``), the cluster
fault policies (``fault_tolerance``) and int8 gradient compression with
error feedback for the data-parallel all-reduce (``compression``) — the
counterpart of ``repro.training``."""
