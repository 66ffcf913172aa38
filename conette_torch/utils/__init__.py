"""Host utilities: WAV I/O, stopwords."""
