"""Public model API: config, preprocessor, model, weight files, AudioSet names."""
