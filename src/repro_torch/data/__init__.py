"""Host-side data pipeline of the LM trainer (`repro/data`)."""
