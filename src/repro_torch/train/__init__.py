"""The training runtime of the port: AdamW, checkpoints, the trainer
with failure recovery, and int8 gradient compression (the PyTorch
counterpart of ``repro.train``)."""
