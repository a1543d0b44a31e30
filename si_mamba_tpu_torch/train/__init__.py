"""Training: optimizer and schedules (``optim``), the train state and step
(``train_state``), the finetune runner with its input pipeline, validation,
vote and test (``runner_finetune``), checkpoints (``checkpoint``), configs
(``config`` over ``yaml_subset``), the model registry (``registry``),
logging and metrics (``logging_utils``) and the CLI (``cli``)."""
