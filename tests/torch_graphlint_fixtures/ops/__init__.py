# Lives under an 'ops/' path segment on purpose: the host-pull and
# traced-bool-branch rules only police hot paths (ops/, models/).
