"""Paper dataset presets (Table 4 and the §4.3 deep recipe) as
ExperimentSpec factories — copies of `repro.configs.{ppi,reddit,amazon2m}`
building the port's spec classes. The reference's LM architecture
registry (`repro.configs.__init__`) is ported with the LM stack."""
