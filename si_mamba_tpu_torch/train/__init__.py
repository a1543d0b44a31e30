"""Training: optimizer and schedules (``optim``), the train state and step
(``train_state``), and the finetune step with its input pipeline
(``runner_finetune``)."""
