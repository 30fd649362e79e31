"""Log-mel frontend and feature normalization."""
