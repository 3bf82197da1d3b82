"""The dense decoder model: sublayers (``layers``) and assembly (``lm``)."""
