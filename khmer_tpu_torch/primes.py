"""Prime table sizing (parity: reference include/oxli/hashtable.hh:84-128)."""


def is_prime(n):
    n = int(n)
    if n < 2:
        return False
    if n == 2:
        return True
    if n % 2 == 0:
        return False
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def get_n_primes_near_x(n, x):
    """n distinct primes smaller than x, descending (hashtable.hh:
    104-128; raises like khmer/_oxli/utils.pyx when x is too small)."""
    n = int(n)
    x = int(x)
    if x == 1:
        return [1]
    primes = []
    i = x - 1
    if i % 2 == 0:
        i -= 1
    while len(primes) != n and i > 0:
        if is_prime(i):
            primes.append(i)
        if i == 1:
            break
        i -= 2
    if len(primes) != n:
        raise RuntimeError(
            "unable to find %d prime numbers < %d" % (n, x))
    return primes
