"""The single-card training path: AdamW and its schedules
(``optimizer``), the train step with gradient accumulation
(``train_step``), atomic checkpoints (``checkpoint``) and the cluster
fault policies (``fault_tolerance``) — the counterpart of
``repro.training`` (gradient compression waits for ROADMAP item 13c)."""
