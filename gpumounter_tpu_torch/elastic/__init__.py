"""Elastic intents: declarative GPU counts a pod, kept as annotations on it
(``intents.py``). The reconciler and its work queue come with the
migration machine."""
