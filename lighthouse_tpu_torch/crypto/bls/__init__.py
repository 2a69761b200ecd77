"""BLS12-381 signatures: the host oracle modules (copies of the JAX
package's pure-Python ones) and the signature API whose batch verification
runs on the card."""
