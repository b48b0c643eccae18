"""The LM stack of the port — `repro.models` in PyTorch: architecture
configs (`config`), TensorSpec parameter trees (`spec`), the transformer
layers (`layers`) and the pattern-stacked model with its serving entry
points `prefill` / `decode_step` (`lm`). The MoE FFN, the SSM blocks
(`repro.models.gla`) and the training loss come in later slices."""
