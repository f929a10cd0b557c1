"""The STrajNet model stack."""
