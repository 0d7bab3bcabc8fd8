/* Batched GF(p) Montgomery arithmetic and a batched G1 Jacobian ladder
   for BLS12-381: the native lane of sign_many.

   The C source of the JAX package's cffi extension
   (dag_rider_tpu/ops/native381.py), unchanged in its arithmetic; here it
   builds with gcc -O2 -shared -fPIC into the repository's build/
   directory and binds with ctypes (dag_rider_tpu_torch/ops/native381.py).

   The ladder transcribes the oracle's _jac_double (EFD dbl-2009-l) and
   _jac_madd (madd-2007-bl) formulas of crypto/bls12381.py including both
   exceptional branches, over exact mod-p arithmetic, so [k]P here equals
   the oracle's [k]P for every scalar and every curve point. */
#include <stdint.h>
#include <stddef.h>
typedef unsigned __int128 u128;

static const uint64_t PL[6] = {
  0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
  0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const uint64_t N0INV = 0x89f3fffcfffcfffdULL; /* -P^-1 mod 2^64 */

static void mont_mul(uint64_t* t, const uint64_t* a, const uint64_t* b){
  uint64_t r[7] = {0,0,0,0,0,0,0};
  for(int i=0;i<6;i++){
    u128 c = 0;
    for(int j=0;j<6;j++){ c += (u128)a[i]*b[j] + r[j]; r[j] = (uint64_t)c; c >>= 64; }
    uint64_t hi = r[6] + (uint64_t)c;
    uint64_t m = r[0]*N0INV;
    c = (u128)m*PL[0] + r[0]; c >>= 64;
    for(int j=1;j<6;j++){ c += (u128)m*PL[j] + r[j]; r[j-1] = (uint64_t)c; c >>= 64; }
    c += hi; r[5] = (uint64_t)c; r[6] = (uint64_t)(c>>64);
  }
  uint64_t s[6]; u128 br = 0;
  for(int j=0;j<6;j++){ u128 d = (u128)r[j] - PL[j] - (uint64_t)br; s[j]=(uint64_t)d; br = (d >> 64) & 1; }
  int ge = (r[6] || !br);
  for(int j=0;j<6;j++) t[j] = ge ? s[j] : r[j];
}

static void addmod(uint64_t* t, const uint64_t* a, const uint64_t* b){
  uint64_t r[6]; u128 c = 0;
  for(int j=0;j<6;j++){ c += (u128)a[j] + b[j]; r[j]=(uint64_t)c; c >>= 64; }
  /* a,b < p < 2^381 so no carry out of limb 5 */
  uint64_t s[6]; u128 br = 0;
  for(int j=0;j<6;j++){ u128 d = (u128)r[j] - PL[j] - (uint64_t)br; s[j]=(uint64_t)d; br = (d >> 64) & 1; }
  int ge = !br;
  for(int j=0;j<6;j++) t[j] = ge ? s[j] : r[j];
}

static void submod(uint64_t* t, const uint64_t* a, const uint64_t* b){
  uint64_t r[6]; u128 br = 0;
  for(int j=0;j<6;j++){ u128 d = (u128)a[j] - b[j] - (uint64_t)br; r[j]=(uint64_t)d; br = (d >> 64) & 1; }
  if(br){ u128 c = 0; for(int j=0;j<6;j++){ c += (u128)r[j] + PL[j]; r[j]=(uint64_t)c; c >>= 64; } }
  for(int j=0;j<6;j++) t[j]=r[j];
}

static int is_zero6(const uint64_t* a){
  for(int j=0;j<6;j++) if(a[j]) return 0;
  return 1;
}
static void cpy6(uint64_t* d, const uint64_t* s){
  for(int j=0;j<6;j++) d[j]=s[j];
}

/* EFD dbl-2009-l, the oracle's _jac_double line for line */
static void jac_double(uint64_t* X, uint64_t* Y, uint64_t* Z){
  uint64_t A[6],B[6],C[6],D[6],E[6],t[6],u[6],X3[6],Y3[6],Z3[6];
  mont_mul(A,X,X); mont_mul(B,Y,Y); mont_mul(C,B,B);
  addmod(t,X,B); mont_mul(t,t,t); submod(t,t,A); submod(t,t,C); addmod(D,t,t);
  addmod(E,A,A); addmod(E,E,A);
  mont_mul(X3,E,E); addmod(u,D,D); submod(X3,X3,u);
  submod(u,D,X3); mont_mul(u,E,u);
  addmod(t,C,C); addmod(t,t,t); addmod(t,t,t); submod(Y3,u,t);
  mont_mul(t,Y,Z); addmod(Z3,t,t);
  cpy6(X,X3); cpy6(Y,Y3); cpy6(Z,Z3);
}

/* EFD madd-2007-bl, the oracle's _jac_madd including both exceptional
   branches (H==0 & S2==Y1 -> double; H==0 else -> identity). */
static void jac_madd(uint64_t* X, uint64_t* Y, uint64_t* Z,
                     const uint64_t* x2, const uint64_t* y2){
  uint64_t Z1Z1[6],U2[6],S2[6],H[6],rr[6],HH[6],I[6],J[6],V[6];
  uint64_t t[6],u[6],X3[6],Y3[6],Z3[6];
  mont_mul(Z1Z1,Z,Z);
  mont_mul(U2,x2,Z1Z1);
  mont_mul(S2,y2,Z); mont_mul(S2,S2,Z1Z1);
  submod(H,U2,X);
  submod(t,S2,Y); addmod(rr,t,t);
  if(is_zero6(H)){
    if(is_zero6(t)){ jac_double(X,Y,Z); return; }
    for(int j=0;j<6;j++) Z[j]=0;
    return;
  }
  mont_mul(HH,H,H);
  addmod(I,HH,HH); addmod(I,I,I);
  mont_mul(J,H,I);
  mont_mul(V,X,I);
  mont_mul(X3,rr,rr); submod(X3,X3,J); addmod(u,V,V); submod(X3,X3,u);
  submod(u,V,X3); mont_mul(u,rr,u);
  mont_mul(t,Y,J); addmod(t,t,t); submod(Y3,u,t);
  addmod(t,Z,H); mont_mul(t,t,t); submod(t,t,Z1Z1); submod(Z3,t,HH);
  cpy6(X,X3); cpy6(Y,Y3); cpy6(Z,Z3);
}

void mont_mul_batch(uint64_t* out, const uint64_t* a, const uint64_t* b,
                    size_t n){
  for(size_t i=0;i<n;i++) mont_mul(out+6*i, a+6*i, b+6*i);
}

void mont_pow_batch(uint64_t* out, const uint64_t* base,
                    const uint64_t* exp, int expbits, size_t n){
  for(size_t i=0;i<n;i++){
    uint64_t acc[6]; const uint64_t* b = base+6*i;
    for(int j=0;j<6;j++) acc[j]=b[j];
    for(int k=expbits-2;k>=0;k--){
      mont_mul(acc,acc,acc);
      if((exp[k/64]>>(k%64))&1) mont_mul(acc,acc,b);
    }
    for(int j=0;j<6;j++) out[6*i+j]=acc[j];
  }
}

/* Batched left-to-right double-and-add over Jacobian coords; identity is
   Z == 0 (Montgomery canonical forms make limb-zero == field-zero). The
   accumulators arrive zeroed (identity), exactly mirroring the oracle's
   acc = None start in _ec_mul_raw / _ec_msm. */
void g1_ladder_batch(uint64_t* X, uint64_t* Y, uint64_t* Z,
                     const uint64_t* px, const uint64_t* py,
                     const uint64_t* rone, const unsigned char* bits,
                     int nbits, size_t rows){
  for(size_t r=0;r<rows;r++){
    uint64_t *x=X+6*r, *y=Y+6*r, *z=Z+6*r;
    const uint64_t *bx=px+6*r, *by=py+6*r;
    const unsigned char* rb = bits + (size_t)nbits*r;
    for(int b=0;b<nbits;b++){
      if(!is_zero6(z)) jac_double(x,y,z);
      if(rb[b]){
        if(is_zero6(z)){ cpy6(x,bx); cpy6(y,by); cpy6(z,rone); }
        else jac_madd(x,y,z,bx,by);
      }
    }
  }
}
