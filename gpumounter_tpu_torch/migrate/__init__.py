"""Live migration's state: the journal kept as an annotation on the source
pod (``journal.py``). The orchestrator comes with the reconciler."""
