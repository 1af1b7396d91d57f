"""The probe transformer, ported."""
