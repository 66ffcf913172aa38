"""Audio frontend: STFT, mel filterbank, log-mel, host resampling."""
