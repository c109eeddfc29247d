"""Host-side data helpers of the port: the dialog templates, the system
prompts and the finetune dataset and sampler."""
