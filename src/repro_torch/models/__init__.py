"""The LM stack of the port — `repro.models` in PyTorch: architecture
configs (`config`), TensorSpec parameter trees (`spec`), the transformer
layers with the MoE FFN (`layers`) and the pattern-stacked model with
its serving entry points `prefill` / `decode_step` / `encode` (`lm`).
The SSM blocks (`repro.models.gla`) and the training loss come in later
slices."""
